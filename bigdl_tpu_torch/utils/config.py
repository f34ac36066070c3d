"""Typed configuration: the fields the ported code reads.

Port of ``bigdl_tpu/utils/config.py`` cut to the ported modules' fields,
with the same names and the same ``BIGDL_TPU_*`` environment variables.
Resolution order (later wins): dataclass defaults, the per-workload
``tuned_configs.json`` entry (``utils/tuned.resolve_default``, only where
a call site names a workload and the field is still at its default),
environment variables, explicit :func:`configure` calls.  The config
records where each field's value came from (:meth:`Config.source`).

A field comes with the module that reads it: the reference's fields that
no code reads (``prefetch_batches``, ``loader_workers``,
``compute_dtype``, ``matmul_precision``, ``log_every_n_iterations``,
``summary_flush_secs``) are left out, as are the TPU's ``kernel_impl``
and ``int8_block_rows``, and the mesh-axis fields wait for their modules.
``BIGDL_TPU_TELEMETRY`` is the short alias of
``BIGDL_TPU_TELEMETRY_ENABLED``, as in the reference.
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
    # default per-request deadline a ReplicaSet stamps on submissions
    # (0 = none): it travels with the request, expired work is refused
    # before the device call, and the supervisor fails work stuck on a
    # dead replica so the router can retry it elsewhere
    serving_deadline_ms: float = 0.0
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
    # gradient sync of DistriOptimizer (parallel/grad_sync.py): gradients
    # are flattened into buckets of at most grad_bucket_bytes (f32
    # accounting), and each bucket crosses the wire as grad_wire_dtype:
    # "f32" | "bf16" (unbiased stochastic rounding) | "f16" (round to
    # nearest, saturating at +-65504/world); the update always runs on
    # f32 master slices
    grad_bucket_bytes: int = 4 << 20
    grad_wire_dtype: str = "f32"
    # activation-memory policy of the training driver when the optimizer
    # sets none (Optimizer.set_activation_memory): "none" | "dots" |
    # "full" | "bf16" | "bf16+dots" | "bf16+full"
    activation_memory: str = "none"
    # anomaly detection: autograd fails at the first backward that makes a
    # NaN (torch.autograd.set_detect_anomaly; apply_debug_config)
    debug_nans: bool = False
    # fault injection (resilience/faults.py): a deterministic plan seeded
    # by fault_seed ("" = no injector object exists: the inert state)
    fault_plan: str = ""
    fault_seed: int = 0
    # telemetry (telemetry/): the driver's step-timeline tracer, metric
    # registry and watchdogs.  Inert: turning it on adds no launch and
    # no host sync, and the losses stay bitwise equal.
    # telemetry_trace_path: write the Chrome-trace JSON there when
    # training ends ("" = keep it in memory); past
    # telemetry_trace_capacity spans the tracer drops and counts
    telemetry_enabled: bool = False
    telemetry_trace_path: str = ""
    telemetry_trace_capacity: int = 200_000
    # admin plane (telemetry/admin.py): /metrics, /healthz, /trace,
    # /flight and /profile?seconds=N on 127.0.0.1:admin_port; 0 = off
    # (no socket, no thread)
    admin_port: int = 0
    # request-scoped tracing (telemetry/context.py): a RequestContext per
    # serving submit; off = none is ever allocated
    request_tracing: bool = False
    # flight recorder (telemetry/flight.py): the append-and-flush JSONL
    # event stream ("" = off: nothing allocated, nothing opened) and its
    # in-memory ring's bound
    flight_recorder_path: str = ""
    flight_recorder_capacity: int = 4096
    # wire front end (frontend/server.py): the port FrontendServer(
    # port=None) binds (0 = config-driven construction is refused;
    # nothing auto-starts either way); a bearer token every request must
    # carry when set (a non-loopback bind needs one); the connection
    # core, "eventloop" (selector loops, no thread per connection) or
    # "threaded" (a thread per connection); the loop count; the cap on
    # open connections (0 = none); the idle keep-alive reap timeout
    # (0 = never); whether each loop thread is pinned to one CPU
    frontend_port: int = 0
    frontend_auth_token: str = ""
    frontend_core: str = "eventloop"
    frontend_shards: int = 1
    frontend_max_connections: int = 10000
    frontend_idle_timeout_s: float = 120.0
    frontend_pin_cpus: bool = False
    # lockdep (utils/lockdep.py): the lock-order sanitizer of the
    # threaded host plane (off = nothing patched); lockdep_hold_ms also
    # records holds longer than it (0 = no wall-clock check)
    lockdep: bool = False
    lockdep_hold_ms: float = 200.0
    # spmdcheck (utils/spmdcheck.py): the collective-schedule sanitizer
    # (off = each note site is one global read)
    spmdcheck: bool = False
    # provenance: field -> "env" | "explicit" for every overridden field;
    # absent = still the dataclass default, the one state a tuned value
    # may fill.  Private: not a knob.
    _sources: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    def source(self, name: str) -> str:
        """Where ``name``'s value came from: ``"default"``, ``"env"`` or
        ``"explicit"``."""
        return self._sources.get(name, "default")

    @classmethod
    def from_env(cls) -> "Config":
        cfg = cls()
        for f in dataclasses.fields(cls):
            if f.name.startswith("_"):
                continue  # bookkeeping, not a knob
            env = _ENV_PREFIX + f.name.upper()
            if env in os.environ:
                typ = type(getattr(cfg, f.name))
                raw = os.environ[env]
                if typ is bool:
                    val = raw.strip().lower() in ("1", "true", "yes", "on")
                else:
                    val = typ(raw)
                setattr(cfg, f.name, val)
                cfg._sources[f.name] = "env"
        # short alias: BIGDL_TPU_TELEMETRY=1 is BIGDL_TPU_TELEMETRY_ENABLED=1
        # (the long form wins when both are set)
        alias = _ENV_PREFIX + "TELEMETRY"
        if alias in os.environ and \
                _ENV_PREFIX + "TELEMETRY_ENABLED" not in os.environ:
            cfg.telemetry_enabled = os.environ[alias].strip().lower() in (
                "1", "true", "yes", "on")
            cfg._sources["telemetry_enabled"] = "env"
        return cfg


_config: Optional[Config] = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config.from_env()
        if _config.debug_nans:
            # BIGDL_TPU_DEBUG_NANS=1 alone is enough
            apply_debug_config(_config)
    return _config


def configure(**kw) -> Config:
    """Override config fields programmatically (highest precedence)."""
    cfg = get_config()
    for k, v in kw.items():
        if k.startswith("_") or not hasattr(cfg, k):
            names = [f.name for f in dataclasses.fields(Config)
                     if not f.name.startswith("_")]
            raise AttributeError(
                f"unknown config field {k!r}; fields: {names}")
        setattr(cfg, k, v)
        cfg._sources[k] = "explicit"
    if "debug_nans" in kw:
        apply_debug_config(cfg)
    return cfg


def reset_config() -> None:
    """Drop overrides; the next get_config() re-reads the environment."""
    global _config
    _config = None


def apply_debug_config(cfg: Optional[Config] = None) -> None:
    """Push the debug toggles into torch: ``debug_nans`` turns on
    autograd's anomaly detection, so the first backward that makes a NaN
    fails loudly (the reference turns on ``jax_debug_nans``)."""
    import torch
    cfg = cfg or get_config()
    torch.autograd.set_detect_anomaly(bool(cfg.debug_nans))
