"""Checkpoint save/load: the thin shim over :mod:`bigdl_tpu_torch.checkpoint`
(port of ``bigdl_tpu/utils/checkpoint.py``), with its ``save_checkpoint`` /
``load_checkpoint`` / ``latest_checkpoint`` signatures.  Files are v3
snapshots (``.npz``, data only, a CRC32-C manifest)."""

from __future__ import annotations

import os
from typing import Optional

from bigdl_tpu_torch.checkpoint.snapshot import (SnapshotError,
                                                 capture_to_host,
                                                 load_snapshot,
                                                 write_snapshot)


def save_checkpoint(path: str, params, model_state=None, opt_state=None,
                    driver_state: Optional[dict] = None,
                    neval: Optional[int] = None,
                    overwrite: bool = True) -> str:
    """Write a checkpoint: ``path/model.<neval>`` with ``neval``, else
    ``path`` itself.  ``overwrite=False`` raises ``FileExistsError`` on
    an existing file."""
    if neval is not None:
        os.makedirs(path, exist_ok=True)
        fname = os.path.join(path, f"model.{neval}")
    else:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fname = path
    return write_snapshot(fname, params=capture_to_host(params),
                          model_state=capture_to_host(model_state),
                          opt_state=capture_to_host(opt_state),
                          driver_state=driver_state, step=neval,
                          overwrite=overwrite)


def load_checkpoint(path: str):
    """Load a checkpoint (any snapshot): a dict with params / model_state
    / opt_state (trees of CPU tensors) and driver_state.  Verified first:
    a torn or corrupt file raises ``ValueError``."""
    try:
        blob = load_snapshot(path)
    except SnapshotError as e:
        raise ValueError(str(e)) from e
    return {k: blob[k]
            for k in ("params", "model_state", "opt_state", "driver_state")}


def latest_checkpoint(folder: str) -> Optional[str]:
    """The newest valid ``model.N`` file under ``folder`` (torn or
    corrupt snapshots are skipped), or None."""
    if not os.path.isdir(folder):
        return None
    from bigdl_tpu_torch.checkpoint.manager import CheckpointManager
    return CheckpointManager(folder).latest_valid()
