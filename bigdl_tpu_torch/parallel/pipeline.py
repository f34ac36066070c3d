"""Pipeline parallelism over the mesh's ``pipe`` axis, GPipe style (port of
``bigdl_tpu/parallel/pipeline.py``).

:class:`GPipe` holds S copies of one stage module as its children ``"0"``
... ``"S-1"``, each drawn on its own by ``initialize``; given a mesh,
stage s lives on device s of this process's ``pipe`` group
(``mesh.axis_devices("pipe")``: ``["cpu"] * S`` in the tests, ``[cuda:0]
* S`` on one card).  Its forward takes (M, mb, ...) microbatches and runs the
reference's schedule of M + S - 1 ticks: at tick t stage s applies itself
to microbatch t - s and hands the result to stage s + 1 (a copy to the
next device of the group).  The reference computes its bubble ticks and
throws their results away; here a stage skips them, so a stateful stage
(BatchNorm's running statistics) advances once a microbatch, in order, as
the reference's does on its valid ticks.  The backward is autograd's.
Without a mesh the forward is :meth:`GPipe.apply_reference`, the
sequential oracle: every stage over the whole batch in turn.

In the reference's trees a ``GPipe``'s parameters and state are its
stage's tree with every leaf stacked on a leading (S, ...) axis; slice s
is stage s (``interop.to_jax_params`` / ``load_jax_params`` stack and
unstack them).

:class:`MicrobatchedSequential` runs heterogeneous stages (for example
:func:`partition_sequential` of a ``Sequential``) one microbatch at a
time, the stages' state threaded from microbatch to microbatch, with no
placement.  Nothing here keeps a thread or a lock.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import torch

from bigdl_tpu_torch.nn.module import Container, Module, Sequential


def partition_sequential(model: Sequential, num_stages: int
                         ) -> List[Sequential]:
    """Split a Sequential's children into ``num_stages`` stages by layer
    count, the first ``len % num_stages`` one layer longer; the stages
    hold the model's own layers.  Raises ``ValueError`` for a split of
    fewer than one layer a stage."""
    mods = list(model._modules.values())
    if num_stages <= 0 or num_stages > len(mods):
        raise ValueError(f"cannot split {len(mods)} layers into "
                         f"{num_stages} stages")
    sizes = [len(mods) // num_stages] * num_stages
    for i in range(len(mods) % num_stages):
        sizes[i] += 1
    stages, ix = [], 0
    for s in sizes:
        stages.append(Sequential(*mods[ix:ix + s]))
        ix += s
    return stages


class GPipe(Module):
    """A pipeline of ``num_stages`` copies of ``stage`` (see the module
    docstring); ``mesh`` places stage s on device s of its ``axis`` group,
    which must hold ``num_stages`` devices."""

    def __init__(self, stage: Module, num_stages: int, mesh=None,
                 axis: str = "pipe", name: Optional[str] = None):
        super().__init__(name)
        if num_stages < 1:
            raise ValueError(f"a pipeline of {num_stages} stages")
        self.num_stages = num_stages
        self.mesh = mesh
        for s in range(num_stages):
            self.add_module(str(s), copy.deepcopy(stage))
        self.devices = None
        if mesh is not None:
            group = mesh.axis_devices(axis)
            if group is None or len(group) != num_stages:
                raise ValueError(
                    f"{num_stages} stages over a {axis!r} group of "
                    f"{0 if group is None else len(group)} devices: one "
                    f"stage a device")
            self.devices = group
            for s, st in enumerate(self.stages):
                st.to(group[s])

    @property
    def stages(self) -> List[Module]:
        return list(self._modules.values())

    def apply_reference(self, x: torch.Tensor) -> torch.Tensor:
        """The sequential oracle: (M, mb, ...) microbatches folded into one
        batch, through every stage in turn (on its device), unfolded."""
        M, mb = x.shape[:2]
        out = x.reshape((M * mb,) + tuple(x.shape[2:]))
        for s, st in enumerate(self.stages):
            if self.devices is not None:
                out = out.to(self.devices[s])
            out = st(out)
        return out.to(x.device).reshape((M, mb) + tuple(out.shape[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(M, mb, ...) microbatches through the tick schedule; outputs
        (M, mb, ...) on ``x``'s device.  M must divide by the stage
        count, as in the reference, whose feed is sharded over ``pipe``."""
        if self.mesh is None:
            return self.apply_reference(x)
        S, M = self.num_stages, x.shape[0]
        if M % S:
            raise ValueError(f"microbatch count {M} must divide by "
                             f"pipeline stages {S}")
        stages, devs = self.stages, self.devices
        inbox = [None] * S  # the activation waiting at each stage
        outs = [None] * M
        for t in range(M + S - 1):
            # the last stage first: each stage takes what the previous one
            # handed over at tick t - 1 before that one hands over again
            for s in reversed(range(S)):
                j = t - s
                if not 0 <= j < M:
                    continue  # a bubble tick: this stage waits
                y = stages[s](x[j].to(devs[0]) if s == 0 else inbox[s])
                if s == S - 1:
                    outs[j] = y.to(x.device)
                else:
                    inbox[s + 1] = y.to(devs[s + 1])
        return torch.stack(outs)


class MicrobatchedSequential(Container):
    """GPipe's math without placement: the batch cut into
    ``num_microbatches`` microbatches, each through every stage in turn,
    the outputs concatenated; a stateful stage sees the microbatches one
    after another (BatchNorm's running statistics advance once a
    microbatch).  The stages are the children ``"0"``, ``"1"``, ..."""

    def __init__(self, stages: Sequence[Module], num_microbatches: int,
                 name: Optional[str] = None):
        super().__init__(*stages, name=name)
        self.num_microbatches = num_microbatches

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, M = x.shape[0], self.num_microbatches
        if N % M:
            raise ValueError(f"batch {N} not divisible into {M} "
                             f"microbatches")
        outs = []
        for mb in x.chunk(M):
            for st in self._modules.values():
                mb = st(mb)
            outs.append(mb)
        return torch.cat(outs)
