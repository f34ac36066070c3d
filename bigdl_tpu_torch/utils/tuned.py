"""Tuned defaults (port of ``bigdl_tpu/utils/tuned.py``, the port's own copy).

``tuned_configs.json`` at the repository root holds per-workload best
values of ``Config`` knobs, keyed ``workload@backend``.  Call sites
resolve a knob through :func:`resolve_default`:

    explicit setter (``configure()``, ``Engine.set_*``, an optimizer's
    setters) > ``BIGDL_TPU_*`` environment variable > tuned entry for
    ``workload@backend`` > dataclass default

so a tuned value fills only a slot left at its default.  The backend is
the run's device type, ``"cpu"`` or ``"cuda"``: the checked-in file's
``@cpu`` entries apply to a CPU run, as they do in the reference, and no
entry yet exists for the card.

An absent or empty file is inert.  A malformed one (wrong schema version,
unknown knob, wrong type, missing provenance) is rejected whole with one
logged error.  The parsed file is cached; ``Engine.reset()`` drops it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional, Tuple

from bigdl_tpu_torch.utils.config import Config, get_config

logger = logging.getLogger("bigdl_tpu_torch.tuned")

SCHEMA_VERSION = 1
ENV_PATH = "BIGDL_TPU_TUNED_CONFIGS"

# None = not loaded yet; a dict = the validated entries (empty when the
# file is absent, empty or rejected)
_entries: Optional[dict] = None


class TunedConfigError(ValueError):
    """A tuned_configs.json that cannot be trusted."""


def default_path() -> str:
    """``$BIGDL_TPU_TUNED_CONFIGS`` when set, else ``tuned_configs.json``
    in the directory that holds the ``bigdl_tpu_torch`` package."""
    env = os.environ.get(ENV_PATH)
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "tuned_configs.json")


def _knob_types() -> dict:
    return {f.name: getattr(Config(), f.name)
            for f in dataclasses.fields(Config)
            if not f.name.startswith("_")}


def _type_ok(default, value) -> bool:
    """Same type as the ``Config`` default; a bool is no int here, an int
    is a float."""
    if isinstance(default, bool) or isinstance(value, bool):
        return isinstance(default, bool) and isinstance(value, bool)
    if isinstance(default, float):
        return isinstance(value, (int, float))
    return isinstance(value, type(default))


def validate_document(doc) -> dict:
    """The entries of a parsed tuned-configs document, or
    :class:`TunedConfigError` naming the first problem."""
    if not isinstance(doc, dict):
        raise TunedConfigError(
            f"top level must be an object, got {type(doc).__name__}")
    version = doc.get("schema_version")
    if version != SCHEMA_VERSION:
        raise TunedConfigError(
            f"schema_version {version!r} != supported {SCHEMA_VERSION} "
            f"— stale or future file; re-run tools/autotune.py")
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        raise TunedConfigError("'entries' must be an object")
    knobs = _knob_types()
    for key, entry in entries.items():
        if not isinstance(entry, dict):
            raise TunedConfigError(f"entry {key!r} must be an object")
        workload = entry.get("workload")
        backend = entry.get("backend")
        if (not isinstance(workload, str) or not isinstance(backend, str)
                or key != f"{workload}@{backend}"):
            raise TunedConfigError(
                f"entry key {key!r} must equal '<workload>@<backend>' "
                f"and match its workload={workload!r} backend="
                f"{backend!r} fields")
        best = entry.get("best")
        if not isinstance(best, dict) or not best:
            raise TunedConfigError(
                f"entry {key!r}: 'best' must be a non-empty object")
        for knob, value in best.items():
            if knob not in knobs:
                raise TunedConfigError(
                    f"entry {key!r}: unknown knob {knob!r} — tuned "
                    f"knobs must exist on Config")
            if not _type_ok(knobs[knob], value):
                raise TunedConfigError(
                    f"entry {key!r}: knob {knob!r} value {value!r} "
                    f"({type(value).__name__}) does not match the "
                    f"Config field type "
                    f"({type(knobs[knob]).__name__})")
        if not isinstance(entry.get("provenance"), dict):
            raise TunedConfigError(
                f"entry {key!r}: 'provenance' (toolchain stamp, "
                f"windows, score) is required — unattributed tuning "
                f"numbers are not trusted")
    return entries


def load(path: Optional[str] = None, force: bool = False) -> dict:
    """The validated entries, cached: ``{}`` for an absent or empty file,
    ``{}`` and one logged error for a damaged one."""
    global _entries
    if _entries is not None and not force and path is None:
        return _entries
    p = path or default_path()
    entries: dict = {}
    if os.path.exists(p):
        try:
            with open(p, "r", encoding="utf-8") as fh:
                text = fh.read()
            if text.strip():
                entries = validate_document(json.loads(text))
        except (OSError, json.JSONDecodeError, TunedConfigError) as e:
            logger.error(
                "tuned_configs.json REJECTED — tuned-default layer "
                "disabled for this process (%s: %s: %s).  Fix or "
                "delete the file, or point %s elsewhere, then "
                "Engine.reset() to reload.",
                p, type(e).__name__, e, ENV_PATH)
            entries = {}
    if path is None:
        _entries = entries
    return entries


def reset_cache() -> None:
    """Forget the cached file (``Engine.reset()`` calls it)."""
    global _entries
    _entries = None


def default_backend() -> str:
    """The backend of a run that names none: ``"cuda"`` when a card is
    present, else ``"cpu"``."""
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def lookup(workload: str, knob: str, backend: Optional[str] = None):
    """The tuned value of ``knob`` under ``workload@backend``, or None."""
    if not workload:
        return None
    entries = load()
    if not entries:
        return None
    entry = entries.get(f"{workload}@{backend or default_backend()}")
    if entry is None:
        return None
    return entry["best"].get(knob)


def resolve_default(knob: str, workload: Optional[str] = None,
                    backend: Optional[str] = None) -> Tuple[object, str]:
    """``(value, source)`` of ``knob`` through the default chain; source
    is ``"explicit"``, ``"env"``, ``"tuned"`` or ``"default"``.  Per-run
    and Engine-level setters sit above this function."""
    cfg = get_config()
    src = cfg.source(knob)
    if src != "default":
        return getattr(cfg, knob), src
    if workload:
        v = lookup(workload, knob, backend=backend)
        if v is not None:
            return v, "tuned"
    return getattr(cfg, knob), "default"
