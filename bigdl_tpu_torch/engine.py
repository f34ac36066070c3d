"""Process-wide runtime state (port of ``bigdl_tpu/engine.py``): ``init``
and ``reset``, the seed, the workload tag, the serving defaults, the
training driver's ``steps_per_dispatch``, and the topology
(``node_number``, ``core_number``, ``device_count`` and the mesh
distributed optimizers shard over).  One process drives one device, so
the process group's world size is both the node and the device count,
and a node has one core in the reference's sense.

Defaults resolve as the reference's do: an Engine-level setter, then
``configure()``/``BIGDL_TPU_*``, then the ``tuned_configs.json`` entry of
the workload on this run's backend (``utils/tuned.py``), then the
dataclass default.

Left out, as TPU facts and knobs: ``kernel_impl``/``set_kernel_impl``
(the device of the tensor picks a kernel or its plain version, with no
knob) and ``set_xla_async_collectives`` (XLA scheduler flags).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.utils import tuned


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — there
    is no quiet move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


class Engine:
    _mesh = None  # set_mesh(); None = a data mesh over the process group
    _initialized = False
    _seed = 1
    _workload: Optional[str] = None  # set_workload()
    _steps_per_dispatch: Optional[int] = None  # set_steps_per_dispatch()

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def init(cls, seed: int = 1) -> None:
        cls._initialized = True
        cls._seed = seed

    @classmethod
    def is_initialized(cls) -> bool:
        return cls._initialized

    @classmethod
    def reset(cls) -> None:
        """Forget the Engine's state and the cached tuned file (the mesh
        is forgotten, not torn down)."""
        cls._mesh = None
        cls._initialized = False
        cls._seed = 1
        cls._workload = None
        cls._steps_per_dispatch = None
        tuned.reset_cache()

    @classmethod
    def seed(cls) -> int:
        return cls._seed

    # -- workload and defaults -----------------------------------------
    @classmethod
    def set_workload(cls, tag: Optional[str]) -> None:
        """Tag the process's workload (``"ptb_lstm"``, ...): tuned defaults
        apply at call sites that carry no tag of their own.  ``None``
        clears it; an optimizer's ``set_workload`` wins at its own run."""
        cls._workload = tag

    @classmethod
    def workload(cls) -> Optional[str]:
        return cls._workload

    @classmethod
    def serving_defaults(cls, workload: Optional[str] = None,
                         backend: Optional[str] = None) -> dict:
        """Defaults for :class:`bigdl_tpu_torch.serving.InferenceService`
        knobs through the default chain; per-service constructor args
        override them."""
        wl = workload if workload is not None else cls._workload
        knobs = {"max_batch_size": "serving_max_batch_size",
                 "batch_timeout_ms": "serving_batch_timeout_ms",
                 "queue_capacity": "serving_queue_capacity",
                 "row_buckets": "serving_row_buckets",
                 # the per-request deadline a ReplicaSet stamps (0 = none)
                 "deadline_ms": "serving_deadline_ms"}
        return {k: tuned.resolve_default(knob, wl, backend)[0]
                for k, knob in knobs.items()}

    @classmethod
    def steps_per_dispatch(cls, workload: Optional[str] = None,
                           backend: Optional[str] = None) -> int:
        """How many train steps the driver enqueues per block when the
        optimizer sets none: :meth:`set_steps_per_dispatch` >
        ``configure()``/``BIGDL_TPU_STEPS_PER_DISPATCH`` > the tuned entry
        of ``workload`` (or :meth:`workload`) on ``backend`` (the run's
        device type; default: ``cuda`` when a card is present) >
        ``Config.steps_per_dispatch``."""
        if cls._steps_per_dispatch is not None:
            return max(1, cls._steps_per_dispatch)
        wl = workload if workload is not None else cls._workload
        return max(1, int(tuned.resolve_default("steps_per_dispatch", wl,
                                                backend)[0]))

    @classmethod
    def set_steps_per_dispatch(cls, k: int) -> None:
        if int(k) < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        cls._steps_per_dispatch = int(k)

    # -- topology ------------------------------------------------------
    @classmethod
    def node_number(cls) -> int:
        """Processes of the job (the reference's executor count): the
        process group's world size, 1 before one exists."""
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_initialized() else 1

    @classmethod
    def core_number(cls) -> int:
        """Devices a process drives: one."""
        return 1

    @classmethod
    def device_count(cls) -> int:
        """Devices of the job: one a process."""
        return cls.node_number()

    @classmethod
    def set_mesh(cls, mesh) -> None:
        cls._mesh = mesh

    @classmethod
    def get_mesh(cls, backend=None):
        """The mesh distributed optimizers shard over: the one
        :meth:`set_mesh` gave, else a data mesh over every process
        (``parallel.create_mesh``, which starts a world-1 group on
        ``backend`` when there is none; with no backend and no group, a
        local mesh that joined none)."""
        if cls._mesh is None:
            from bigdl_tpu_torch.parallel.mesh import create_mesh
            cls._mesh = create_mesh(backend=backend)
        return cls._mesh
