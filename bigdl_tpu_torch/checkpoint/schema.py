"""Training-state schema: build, hash and diff-validate on resume (port of
``bigdl_tpu/checkpoint/schema.py``).

A snapshot's manifest records the parameter tree (shapes and dtypes), the
gradient-sync configuration and the optimizer method; resume compares it
field by field with the current run and refuses, with a diff, any drift.

The parameter tree is the reference's pytree layout of the model (nested
dicts keyed by child index, see ``interop/jax_weights.py``), and each leaf
path is written as ``jax.tree_util.keystr`` writes it (``['1']['weight']``)
with dtypes under numpy's names, so one snapshot's schema reads the same
in both packages.
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Optional, Tuple

import numpy as np


class SchemaMismatchError(ValueError):
    """Resume state does not match the snapshot's schema."""


def _dtype_name(leaf) -> str:
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return type(leaf).__name__
    return str(dt).replace("torch.", "")


def leaves_with_path(tree, path=(), keys=False):
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten`` order: dict
    keys sorted, sequences in order; None and empty containers hold no
    leaf.  The path is ``jax.tree_util.keystr``'s string
    (``"['0']['weight']"``), or with ``keys`` the tuple of dict keys and
    sequence indices."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(
                tree[k], path + ((k if keys else f"[{k!r}]"),), keys)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(
                v, path + ((i if keys else f"[{i}]"),), keys)
    else:
        yield (path if keys else "".join(path)), tree


def describe_params(params) -> dict:
    """Parameter tree -> ``{leaf path: "shape:dtype"}`` (the architecture
    fingerprint)."""
    out = {}
    for key, leaf in leaves_with_path(params):
        shape = getattr(leaf, "shape", None)
        shape = tuple(int(d) for d in (np.shape(leaf) if shape is None
                                       else shape))
        out[key] = f"{shape}:{_dtype_name(leaf)}"
    return out


def build_schema(params, *, grad_sync: bool = False,
                 bucket_sizes: Optional[List[int]] = None,
                 wire_dtype: Optional[str] = None,
                 n_shard: Optional[int] = None,
                 optim_method: Optional[str] = None,
                 bucket_content: Optional[List[int]] = None) -> dict:
    """The schema dict a snapshot manifest carries (JSON-able).
    ``bucket_content`` is the unpadded element count a bucket."""
    gs: dict = {"enabled": bool(grad_sync)}
    if grad_sync:
        gs.update(bucket_sizes=[int(s) for s in (bucket_sizes or [])],
                  wire_dtype=str(wire_dtype), n_shard=int(n_shard or 1))
        if bucket_content is not None:
            gs["bucket_content"] = [int(s) for s in bucket_content]
    return {
        "params": describe_params(params),
        "grad_sync": gs,
        "optim_method": optim_method,
    }


def schema_hash(schema: dict) -> str:
    """Stable short hash of the canonical JSON form."""
    blob = json.dumps(schema, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def _diff_section(lines: List[str], label: str, saved, current) -> None:
    if saved != current:
        lines.append(f"  {label}:")
        lines.append(f"    - snapshot: {saved}")
        lines.append(f"    + current:  {current}")


def diff_schemas(saved: dict, current: dict,
                 elastic: bool = False) -> List[str]:
    """Human-readable diff lines (empty = compatible).  ``elastic=True``
    lets the padded ``bucket_sizes`` and ``n_shard`` differ (a world-size
    change) and keeps everything else strict."""
    lines: List[str] = []
    _diff_section(lines, "optim_method", saved.get("optim_method"),
                  current.get("optim_method"))
    sgs, cgs = saved.get("grad_sync") or {}, current.get("grad_sync") or {}
    if bool(sgs.get("enabled")) != bool(cgs.get("enabled")):
        _diff_section(lines, "grad_sync.enabled", sgs.get("enabled"),
                      cgs.get("enabled"))
    elif sgs.get("enabled"):
        keys = (("wire_dtype", "bucket_content") if elastic
                else ("bucket_sizes", "wire_dtype", "n_shard"))
        for k in keys:
            if elastic and k == "bucket_content" \
                    and (k not in sgs or k not in cgs):
                continue
            _diff_section(lines, f"grad_sync.{k}", sgs.get(k), cgs.get(k))
    sp, cp = saved.get("params") or {}, current.get("params") or {}
    for key in sorted(set(sp) | set(cp)):
        _diff_section(lines, f"params{key}", sp.get(key, "<absent>"),
                      cp.get(key, "<absent>"))
    return lines


def elastic_compatible(saved: Optional[dict],
                       current: dict) -> Tuple[bool, List[str]]:
    """Would an elastic resume accept this snapshot?  ``(verdict,
    diff_lines)``, the operator's form of :func:`validate_schema` with
    ``elastic=True``.  A legacy snapshot without a schema is compatible
    with a caveat line: the structural checks apply at restore time."""
    if saved is None:
        return True, ["(legacy snapshot: no schema — structural "
                      "checks apply at restore time)"]
    lines = diff_schemas(saved, current, elastic=True)
    return not lines, lines


def validate_schema(saved: Optional[dict], current: dict,
                    source: str = "checkpoint",
                    elastic: bool = False) -> None:
    """Raise :class:`SchemaMismatchError` with the full diff when the
    snapshot's schema and the current run's disagree (``saved=None``, a
    snapshot without a schema, validates nothing)."""
    if saved is None:
        return
    lines = diff_schemas(saved, current, elastic=elastic)
    if not lines:
        return
    hints = []
    sgs, cgs = (saved.get("grad_sync") or {}), \
        (current.get("grad_sync") or {})
    if bool(sgs.get("enabled")) != bool(cgs.get("enabled")):
        hints.append("resume with the matching grad_sync / "
                     "parameter_sharding setting")
    elif sgs.get("enabled") and sgs != cgs:
        if elastic:
            hints.append("the bucket CONTENT layout drifted — an "
                         "elastic resume only tolerates world-size/"
                         "padding changes, not grad_bucket_bytes or "
                         "wire-dtype changes")
        else:
            hints.append("the bucket plan drifted — restore the "
                         "original mesh size / grad_bucket_bytes / "
                         "grad_wire_dtype (or resume elastically: "
                         "world-size drift alone is resumable)")
    if (saved.get("params") or {}) != (current.get("params") or {}):
        hints.append("the model architecture changed since the "
                     "snapshot was written")
    hints.append("or clear the checkpoint directory to start fresh")
    raise SchemaMismatchError(
        f"{source} schema mismatch — refusing to resume (the saved "
        "state would be silently reinterpreted):\n"
        + "\n".join(lines) + "\nhint: " + "; ".join(hints))
