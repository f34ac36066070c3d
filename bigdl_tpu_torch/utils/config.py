"""Typed configuration: the fields the serving and training slices read.

Port of ``bigdl_tpu/utils/config.py`` cut to this slice's fields, with the
same names and the same ``BIGDL_TPU_*`` environment variables.
Resolution order (later wins): dataclass defaults, then environment
variables, then explicit :func:`configure` calls.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

_ENV_PREFIX = "BIGDL_TPU_"


@dataclasses.dataclass
class Config:
    # serving: a coalesced batch dispatches when it reaches
    # serving_max_batch_size rows or serving_batch_timeout_ms after its
    # first request (0 = adaptive: dispatch what is already queued); the
    # queue holds at most serving_queue_capacity requests before submit()
    # raises ServiceOverloaded.  serving_row_buckets is the bucket-set spec
    # parsed by serving.parse_row_buckets ("" = power-of-two buckets).
    serving_max_batch_size: int = 32
    serving_batch_timeout_ms: float = 2.0
    serving_queue_capacity: int = 256
    serving_row_buckets: str = ""
    # default activation mode quantize(model) stamps on converted layers:
    # "weight_only" (int8 weights, f32/bf16 activations, f32 accumulate)
    # or "dynamic" (per-tensor int8 activations, exact integer sum)
    int8_activation_mode: str = "weight_only"
    # training driver: K consecutive train steps enqueued back to back as
    # one block, with no host sync inside it; blocks end early at epoch
    # and trigger boundaries, so results do not depend on K
    steps_per_dispatch: int = 1
    # seed of an optimizer's run (Optimizer.set_seed overrides it): the
    # Dropout generators of its training copy are drawn from it
    seed: int = 1
    # checkpointing (Optimizer.set_checkpoint's defaults): retention keeps
    # the newest checkpoint_keep_last snapshots plus (with
    # checkpoint_keep_every=N) every N-th step; checkpoint_async commits
    # snapshots on a bounded background writer
    checkpoint_keep_last: int = 5
    checkpoint_keep_every: int = 0
    checkpoint_async: bool = True
    # non-finite loss/gradient policy of the training driver
    # (resilience/numeric.py): "off" | "skip" | "rollback" | "abort";
    # rollback restores the latest valid snapshot at most
    # failure_retry_times times
    numeric_guard: str = "off"
    failure_retry_times: int = 5

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            env = _ENV_PREFIX + f.name.upper()
            if env in os.environ:
                typ = type(getattr(cfg, f.name))
                raw = os.environ[env]
                if typ is bool:
                    val = raw.strip().lower() in ("1", "true", "yes", "on")
                else:
                    val = typ(raw)
                setattr(cfg, f.name, val)
        return cfg


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
    return _config


def configure(**kw) -> Config:
    """Override config fields programmatically (highest precedence)."""
    cfg = get_config()
    for k, v in kw.items():
        if not hasattr(cfg, k):
            names = [f.name for f in dataclasses.fields(Config)]
            raise AttributeError(
                f"unknown config field {k!r}; fields: {names}")
        setattr(cfg, k, v)
    return cfg


def reset_config() -> None:
    """Drop overrides; the next get_config() re-reads the environment."""
    global _config
    _config = None
