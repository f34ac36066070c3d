"""Process-wide defaults (port of ``bigdl_tpu/engine.py``, serving part).

The reference's tuned-config layer (``tuned_configs.json``) is not ported:
its entries were measured on a TPU or a CPU, and none applies to an H100.
"""

from __future__ import annotations

from bigdl_tpu_torch.utils.config import get_config


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
