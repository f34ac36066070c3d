"""Mesh: the topology of a distributed run (port of
``bigdl_tpu/parallel/mesh.py``).

The reference names its devices' axes (``data``, ``model``, ``seq``,
``pipe``) over one ``jax.sharding.Mesh`` that one process drives.  Here
the processes form a ``torch.distributed`` group, the ``data`` axis, and
each process drives a device group of its own, ``model * seq * pipe``
devices laid out as the reference's ``(data, model, seq, pipe)`` reshape
gives one data index (``devices``, e.g. ``[cuda:0, cuda:1]``, ``[cuda:0,
cuda:0]`` on one card or ``["cpu"] * 4``): a :class:`Mesh` is the axes'
sizes, the ``data`` axis's process group and that group, whose first
device is the process's home device.  :meth:`Mesh.axis_devices` gives the
devices along one axis: ``parallel/tensor_parallel.py`` places a model's
shards on the ``model`` group, ``parallel/ring_attention.py`` splits a
sequence over the ``seq`` group and ``parallel/pipeline.py`` puts a
pipeline's stages on the ``pipe`` group.

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
    """Axis sizes of a run, the process group of its ``data`` axis
    (``None``: the default group, every process; ``backend`` None: a local
    mesh that joined no group) and this process's device group
    (``devices``: ``model * seq * pipe`` of them in the reference's
    C-order layout of those axes; None for a data-only mesh, whose
    process places its model on the device its trainer names)."""

    __slots__ = ("shape", "group", "backend", "devices")

    def __init__(self, shape: dict, group=None, backend: Optional[str] = "nccl",
                 devices=None):
        self.shape = dict(shape)
        self.group = group
        self.backend = backend
        self.devices = None if devices is None \
            else tuple(torch.device(d) for d in devices)

    @property
    def home(self) -> Optional[torch.device]:
        """The first device of the model group: where the replicated
        parameters, the activations between layers and the row-parallel
        sums live."""
        return None if self.devices is None else self.devices[0]

    @property
    def axis_names(self):
        return tuple(self.shape)

    def axis_devices(self, axis: str) -> Optional[tuple]:
        """The devices along ``axis`` of this process's group, the other
        axes at index 0 (the reference's ``mesh.devices[0, :, 0, 0]`` for
        ``model``); None for a data-only mesh."""
        if axis not in AXES[1:]:
            raise ValueError(f"{axis!r} is not a device axis of "
                             f"{AXES[1:]}")
        if self.devices is None:
            return None
        sizes = [self.shape[a] for a in AXES[1:]]
        k = AXES[1:].index(axis)
        stride = 1
        for n in sizes[k + 1:]:
            stride *= n
        return tuple(self.devices[i * stride] for i in range(sizes[k]))

    @property
    def size(self) -> int:
        """Processes on the ``data`` axis."""
        return self.shape["data"]

    @property
    def rank(self) -> int:
        """This process's index on the ``data`` axis."""
        if self.backend is None and not dist.is_initialized():
            return 0
        return dist.get_rank(self.group)

    def __repr__(self) -> str:
        devs = "" if self.devices is None \
            else f", devices={[str(d) for d in self.devices]}"
        return f"Mesh({self.shape}, backend={self.backend!r}{devs})"


def _launched() -> bool:
    return "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ


def device_group(model: int, devices=None, seq: int = 1,
                pipe: int = 1) -> Optional[tuple]:
    """This process's device group of ``model * seq * pipe`` devices:
    ``devices``, or by default, on CUDA, that many cards from ``LOCAL_RANK
    * n`` on; None for a group of one without ``devices``."""
    n = model * seq * pipe
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"a device group of model {model} x seq {seq} "
                             f"x pipe {pipe} over {len(devices)} devices: "
                             f"the group is this process's, one device a "
                             f"position")
        return tuple(devices)
    if n == 1:
        return None
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"a device group of {n} (model {model}, seq {seq}, pipe {pipe}) "
            f"lies on CUDA devices by default but CUDA is not available; "
            f"pass devices=['cpu'] * {n} to run it on the CPU")
    first = int(os.environ.get("LOCAL_RANK", 0)) * n
    if first + n > torch.cuda.device_count():
        raise ValueError(
            f"a device group of {n} from cuda:{first} needs {first + n} "
            f"devices, this machine has {torch.cuda.device_count()}; pass "
            f"devices= (the same card may appear more than once)")
    return tuple(torch.device("cuda", first + r) for r in range(n))


def create_mesh(data: int = -1, model: int = 1, seq: int = 1,
                pipe: int = 1, backend: Optional[str] = None,
                devices=None) -> Mesh:
    """A mesh: a ``data`` axis over every process of the group (joined or
    started by :func:`init_process_group`; ``data=-1`` takes them all,
    another value must equal the world size) and the ``model``, ``seq``
    and ``pipe`` axes over this process's device group
    (:func:`device_group`).  With no
    ``backend`` named, no group joined and no launcher's, a mesh whose
    data axis is this one process (``data`` 1 or -1) is local: it joins no
    group (``backend`` None); a ``DistriOptimizer`` given it starts its
    world-1 group when it runs."""
    for name, n in (("model", model), ("seq", seq), ("pipe", pipe)):
        if n < 1:
            raise ValueError(f"a {name} axis of {n}")
    group_devices = device_group(model, devices, seq, pipe)
    shape = {"data": 1, "model": model, "seq": seq, "pipe": pipe}
    if backend is None and not dist.is_initialized() and not _launched() \
            and data in (-1, 1):
        return Mesh(shape, None, None, group_devices)
    backend = init_process_group(backend)
    world = dist.get_world_size()
    if data not in (-1, world):
        raise ValueError(f"a data axis of {data} over {world} processes: "
                         f"one process drives one model device group, so "
                         f"the data axis spans the world")
    return Mesh(dict(shape, data=world), None, backend, group_devices)


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
