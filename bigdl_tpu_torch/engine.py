"""Process-wide defaults (port of ``bigdl_tpu/engine.py``: the serving
defaults, the training driver's ``steps_per_dispatch``, and the topology:
``node_number``, ``device_count`` and the mesh distributed optimizers
shard over).  One process drives one device, so the process group's
world size is both the node and the device count.

The reference's tuned-config layer (``tuned_configs.json``) is not ported:
its entries were measured on a TPU or a CPU, and none applies to an H100.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.utils.config import get_config


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

    @classmethod
    def serving_defaults(cls) -> dict:
        """Defaults for :class:`bigdl_tpu_torch.serving.InferenceService`
        knobs: ``configure()`` > ``BIGDL_TPU_SERVING_*`` env > dataclass
        default.  Per-service constructor args override them."""
        cfg = get_config()
        return {
            "max_batch_size": cfg.serving_max_batch_size,
            "batch_timeout_ms": cfg.serving_batch_timeout_ms,
            "queue_capacity": cfg.serving_queue_capacity,
            "row_buckets": cfg.serving_row_buckets,
        }

    @classmethod
    def steps_per_dispatch(cls) -> int:
        """How many train steps the driver enqueues per block when the
        optimizer sets none: ``configure()``/``BIGDL_TPU_STEPS_PER_DISPATCH``
        > ``Config.steps_per_dispatch``."""
        return max(1, int(get_config().steps_per_dispatch))

    # -- topology ------------------------------------------------------
    @classmethod
    def node_number(cls) -> int:
        """Processes of the job (the reference's executor count): the
        process group's world size, 1 before one exists."""
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_initialized() else 1

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
        ``backend`` when there is none)."""
        if cls._mesh is None:
            from bigdl_tpu_torch.parallel.mesh import create_mesh
            cls._mesh = create_mesh(backend=backend)
        return cls._mesh
