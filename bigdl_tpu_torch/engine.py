"""Process-wide defaults (port of ``bigdl_tpu/engine.py``: the serving
defaults and the training driver's ``steps_per_dispatch``).

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
