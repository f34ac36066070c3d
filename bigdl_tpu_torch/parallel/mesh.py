"""Mesh: the topology of a distributed run (port of
``bigdl_tpu/parallel/mesh.py``).

The reference names its devices' axes (``data``, ``model``, ``seq``,
``pipe``) over one ``jax.sharding.Mesh``.  Here one process drives one
device and the processes form a ``torch.distributed`` group, so a
:class:`Mesh` is the axes' sizes and the ``data`` axis's process group.
Only data parallelism is ported: a ``model``, ``seq`` or ``pipe`` axis
larger than 1 raises ``NotImplementedError``.

A job of several processes starts under ``torchrun`` (or any launcher that
sets ``MASTER_ADDR``/``WORLD_SIZE``/``RANK``) or calls
``torch.distributed.init_process_group`` itself; a run of one process
needs no launcher: :func:`init_process_group` starts a world-1 group on
an in-process ``HashStore``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

AXES = ("data", "model", "seq", "pipe")


def init_process_group(backend: Optional[str] = None) -> str:
    """Join the job's process group (starting a world-1 group when no
    launcher set one up) and return its backend.  ``backend`` (``"nccl"``
    or ``"gloo"``; default ``"nccl"``) must be the group's: an existing
    group of another backend raises, it is never swapped quietly."""
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and have != backend:
            raise ValueError(f"the process group runs {have!r}, this run "
                             f"asked for {backend!r}")
        return have
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("the nccl backend needs CUDA, which is not "
                           "available; pass backend='gloo' (and "
                           "device='cpu') to run on the CPU")
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)  # env://, as torchrun sets it
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return backend


class Mesh:
    """Axis sizes of a run and the process group of its ``data`` axis
    (``None``: the default group, every process)."""

    __slots__ = ("shape", "group", "backend")

    def __init__(self, shape: dict, group=None, backend: str = "nccl"):
        self.shape = dict(shape)
        self.group = group
        self.backend = backend

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self) -> int:
        """Processes on the ``data`` axis."""
        return self.shape["data"]

    @property
    def rank(self) -> int:
        """This process's index on the ``data`` axis."""
        return dist.get_rank(self.group)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r})"


def create_mesh(data: int = -1, model: int = 1, seq: int = 1,
                pipe: int = 1, backend: Optional[str] = None) -> Mesh:
    """A data mesh over every process of the group (joined or started by
    :func:`init_process_group`).  ``data=-1`` takes them all; another
    value must equal the world size."""
    for name, n in (("model", model), ("seq", seq), ("pipe", pipe)):
        if n != 1:
            raise NotImplementedError(
                f"a {name!r} mesh axis of {n} (tensor, sequence or pipeline "
                f"parallelism) is not ported to bigdl_tpu_torch yet "
                f"(ROADMAP queue A, slice 10)")
    backend = init_process_group(backend)
    world = dist.get_world_size()
    if data not in (-1, world):
        raise ValueError(f"a data axis of {data} over {world} processes: "
                         f"one process drives one device, so the data "
                         f"axis spans the world")
    return Mesh({"data": world, "model": 1, "seq": 1, "pipe": 1},
                None, backend)


class Placement(NamedTuple):
    """How a tensor lies on a mesh: dim 0 split over ``axis``, or
    replicated (``axis=None``)."""

    mesh: Mesh
    axis: Optional[str]

    def local(self, tensor: torch.Tensor) -> torch.Tensor:
        """This process's part of ``tensor`` (dim 0 in equal rows)."""
        if self.axis is None:
            return tensor
        n, r = self.mesh.shape[self.axis], self.mesh.rank
        if tensor.shape[0] % n:
            raise ValueError(f"{tensor.shape[0]} rows do not split over "
                             f"{n} processes")
        return tensor.chunk(n)[r]


def data_sharding(mesh: Mesh) -> Placement:
    """The batch dim split over the ``data`` axis."""
    return Placement(mesh, "data")


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def mesh_shape(mesh: Mesh) -> dict:
    return dict(mesh.shape)
