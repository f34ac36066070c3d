"""Atomic, checksummed, asynchronously committed training-state snapshots
(port of ``bigdl_tpu/checkpoint/snapshot.py``).

The wire is the reference's ``.npz`` v3, so either package reads the
other's files:

- **data only**: arrays plus a JSON skeleton of the tree (``__meta__``);
  loading never unpickles.  The ``__manifest__`` member holds the step,
  the schema and a CRC32-C of every array and of the skeleton, so a file
  can be verified, and a torn or corrupt one skipped, without
  deserializing an array;
- **atomic commit**: ``<name>.tmp`` -> flush -> ``fsync`` -> ``os.replace``
  -> directory ``fsync``.  A crash leaves the old file or the new one,
  never a mix;
- **asynchronous hand-off**: :class:`AsyncSnapshotWriter` runs the
  serialization, CRC and fsync on one bounded background thread.

Trees are nested dicts, lists and tuples whose leaves are tensors or
numpy arrays (the reference's pytree layout of the model, see
``interop/jax_weights.py``).  bf16 tensors travel as uint16 with a
``"bfloat16"`` tag, as the reference stores them.  :func:`load_snapshot`
returns CPU tensors.

Device-fetch discipline: :func:`capture_to_host` is called by the driver
at a replay boundary only, after the one-block-behind loss fetch has
synced the block that produced the tensors, so the copy to the host waits
for a copy and never drains the queue of enqueued work.

CRC32-C: the ``crc32c`` C extension when the host has it, else the table
CRC of ``utils/summary.py``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import zipfile
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 3
MANIFEST_MEMBER = "__manifest__"
META_MEMBER = "__meta__"
FORMAT_NAME = "bigdl_tpu-snapshot"

_CRC_CHUNK = 1 << 20


class SnapshotError(ValueError):
    """A snapshot failed to parse or verify (torn file, CRC mismatch,
    foreign format).  Discovery skips it; a direct load raises it."""


# ----------------------------------------------------------------- crc32c
try:
    import crc32c as _crc32c_mod

    def _crc32c_update(data, crc: int) -> int:
        return _crc32c_mod.crc32c(bytes(data), crc)
except ImportError:
    from bigdl_tpu_torch.utils.summary import crc32c as _crc32c_bytes

    def _crc32c_update(data, crc: int) -> int:
        return _crc32c_bytes(bytes(data), crc)


def crc32c_of(buf, crc: int = 0) -> int:
    """CRC32-C of a bytes-like object, chunked so a large array needs no
    second contiguous copy."""
    view = memoryview(buf).cast("B")
    for off in range(0, len(view), _CRC_CHUNK):
        crc = _crc32c_update(view[off:off + _CRC_CHUNK], crc)
    return crc


def _array_crc(arr: np.ndarray) -> Tuple[int, int]:
    """(crc32c, nbytes) over the C-order bytes, what ``np.save`` stores."""
    arr = np.ascontiguousarray(arr)
    view = arr.reshape(-1).view(np.uint8) if arr.size else arr.tobytes()
    return crc32c_of(view), arr.nbytes


# ------------------------------------------------------- tree <-> arrays
def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return fn(tree)


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


# replay-boundary: the producing block is synced before the driver calls
def capture_to_host(tree):
    """A copy of every leaf on the host (tensors as CPU tensors).  On the
    driver path it is called at a replay boundary only, where the block
    that produced the tensors has been synced by the loss fetch; the copy
    also keeps the values safe from the next block's in-place updates."""
    return _map_leaves(_host_copy, tree)


def to_host(tree):
    """Every leaf of ``tree`` as a numpy array (blocking; the reference's
    ``to_host``); a bf16 tensor as f32, which numpy lacks."""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)
    return _map_leaves(host, tree)


def _as_numpy(leaf):
    """(numpy array, wire dtype tag or None) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, None


def encode_tree(tree, arrays: list):
    """Tree -> JSON-able skeleton; array leaves appended to ``arrays`` and
    referenced by index."""
    if isinstance(tree, dict):
        return {"t": "dict",
                "k": list(tree.keys()),
                "v": [encode_tree(tree[k], arrays) for k in tree.keys()]}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "v": [encode_tree(x, arrays) for x in tree]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"t": "py", "v": tree}
    arr, tag = _as_numpy(tree)
    arrays.append(arr)
    if tag is not None:
        return {"t": "arr", "i": len(arrays) - 1, "d": tag}
    return {"t": "arr", "i": len(arrays) - 1}


def decode_tree(node, arrays):
    """Skeleton -> tree of CPU tensors."""
    t = node["t"]
    if t == "dict":
        return {k: decode_tree(v, arrays)
                for k, v in zip(node["k"], node["v"])}
    if t == "list":
        return [decode_tree(v, arrays) for v in node["v"]]
    if t == "tuple":
        return tuple(decode_tree(v, arrays) for v in node["v"])
    if t == "py":
        return node["v"]
    arr = np.array(arrays[f"a{node['i']}"])  # writable, owned
    if node.get("d") == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ------------------------------------------------------------ write / read
def write_snapshot(path: str, *, params, model_state=None, opt_state=None,
                   driver_state: Optional[dict] = None,
                   run_state: Optional[dict] = None,
                   step: Optional[int] = None,
                   schema: Optional[dict] = None,
                   overwrite: bool = True) -> str:
    """Serialize and commit one snapshot atomically; host work only (the
    background writer runs it).  Returns the committed path; with
    ``overwrite=False`` an existing ``path`` raises ``FileExistsError``."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(
            f"{path} exists (reference: overWriteCheckpoint not set)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: List[np.ndarray] = []
    skeleton = {
        "version": FORMAT_VERSION,
        "params": encode_tree(params, arrays),
        "model_state": encode_tree(model_state, arrays)
        if model_state is not None else None,
        "opt_state": encode_tree(opt_state, arrays)
        if opt_state is not None else None,
        "driver_state": dict(driver_state) if driver_state else None,
        "run": dict(run_state) if run_state else None,
    }
    # np.ascontiguousarray would make a 0-d leaf (LBFGS's counters) 1-d
    arrays = [np.require(a, requirements="C") for a in arrays]
    entries = []
    total = 0
    for i, a in enumerate(arrays):
        crc, nbytes = _array_crc(a)
        total += nbytes
        entries.append({"name": f"a{i}", "crc32c": crc, "nbytes": nbytes,
                        "shape": list(a.shape), "dtype": a.dtype.name})
    meta_bytes = json.dumps(skeleton).encode()
    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "step": int(step) if step is not None
        else (driver_state or {}).get("neval"),
        "epoch": (driver_state or {}).get("epoch"),
        "arrays": entries,
        "total_bytes": total,
        # the skeleton is covered too: a bit flip in __meta__ fails
        # verification like one in an array
        "meta_crc32c": crc32c_of(meta_bytes),
        "meta_nbytes": len(meta_bytes),
        "schema": schema,
    }
    if schema is not None:
        from bigdl_tpu_torch.checkpoint.schema import schema_hash
        manifest["schema_hash"] = schema_hash(schema)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            **{META_MEMBER: np.frombuffer(meta_bytes, dtype=np.uint8),
               MANIFEST_MEMBER: np.frombuffer(
                json.dumps(manifest).encode(), dtype=np.uint8)},
            **{e["name"]: a for e, a in zip(entries, arrays)})
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")
    return path


def _fsync_dir(dirname: str) -> None:
    """Make the rename durable; best effort (not every filesystem can)."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def read_manifest(path: str) -> Optional[dict]:
    """The manifest without touching an array member: None for a v2
    archive (no manifest); SnapshotError when the file is no snapshot."""
    try:
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            if META_MEMBER + ".npy" not in names:
                raise SnapshotError(
                    f"{path}: no {META_MEMBER} member — not a bigdl_tpu "
                    "checkpoint (data-only policy: foreign formats are "
                    "never auto-loaded)")
            if MANIFEST_MEMBER + ".npy" not in names:
                return None
            with zf.open(MANIFEST_MEMBER + ".npy") as fp:
                raw = _read_npy_payload(fp)
            return json.loads(raw.decode())
    except (zipfile.BadZipFile, OSError, ValueError, KeyError) as e:
        if isinstance(e, SnapshotError):
            raise
        raise SnapshotError(f"{path}: unreadable snapshot ({e})") from e


def _read_npy_header(fp):
    version = np.lib.format.read_magic(fp)
    if version == (1, 0):
        return np.lib.format.read_array_header_1_0(fp)
    if version == (2, 0):
        return np.lib.format.read_array_header_2_0(fp)
    raise SnapshotError(f"unsupported .npy version {version}")


def _read_npy_payload(fp) -> bytes:
    shape, _, dtype = _read_npy_header(fp)
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return fp.read(n)


def verify_snapshot(path: str, deep: bool = True) -> Tuple[bool, str]:
    """Integrity check without materializing arrays: the manifest, then
    (``deep``) every member streamed through CRC32-C against it.
    ``(ok, detail)``; never raises for a corrupt file."""
    try:
        manifest = read_manifest(path)
    except SnapshotError as e:
        return False, str(e)
    if manifest is None:
        return True, "legacy (v2, no manifest — integrity unverifiable)"
    if not deep:
        return True, "manifest ok (arrays unverified)"
    members = [(e["name"] + ".npy", e["crc32c"], e["nbytes"])
               for e in manifest["arrays"]]
    if "meta_crc32c" in manifest:
        members.append((META_MEMBER + ".npy", manifest["meta_crc32c"],
                        manifest["meta_nbytes"]))
    try:
        with zipfile.ZipFile(path) as zf:
            for member, want_crc, want_bytes in members:
                crc = 0
                nbytes = 0
                with zf.open(member) as fp:
                    _read_npy_header(fp)
                    while True:
                        chunk = fp.read(_CRC_CHUNK)
                        if not chunk:
                            break
                        crc = _crc32c_update(chunk, crc)
                        nbytes += len(chunk)
                if nbytes != want_bytes:
                    return False, (f"{member}: {nbytes} bytes on disk, "
                                   f"manifest says {want_bytes} "
                                   "(torn write)")
                if crc != want_crc:
                    return False, (f"{member}: crc32c {crc:#010x} != "
                                   f"manifest {want_crc:#010x} "
                                   "(corrupt data)")
    except (zipfile.BadZipFile, OSError, KeyError, ValueError) as e:
        return False, f"verification failed: {e}"
    return True, f"ok ({len(manifest['arrays'])} arrays, " \
                 f"{manifest['total_bytes']} bytes)"


def load_snapshot(path: str, verify: bool = True) -> dict:
    """Load a snapshot: params / model_state / opt_state (trees of CPU
    tensors), driver_state, run and manifest.  ``verify`` streams the CRC
    check first, so a corrupt file raises SnapshotError before any array
    is deserialized."""
    if verify:
        ok, detail = verify_snapshot(path)
        if not ok:
            raise SnapshotError(f"{path}: refusing to load — {detail}")
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except (ValueError, OSError, KeyError, zipfile.BadZipFile) as e:
        raise SnapshotError(
            f"{path} is not a bigdl_tpu (npz) checkpoint — legacy or "
            "foreign formats are not auto-loaded (data-only policy); "
            f"original error: {e}") from e
    skeleton = json.loads(bytes(arrays.pop(META_MEMBER)).decode())
    manifest_raw = arrays.pop(MANIFEST_MEMBER, None)
    manifest = json.loads(bytes(manifest_raw).decode()) \
        if manifest_raw is not None else None

    def tree(key):
        node = skeleton.get(key)
        return None if node is None else decode_tree(node, arrays)

    return {
        "params": tree("params"),
        "model_state": tree("model_state"),
        "opt_state": tree("opt_state"),
        "driver_state": skeleton["driver_state"],
        "run": skeleton.get("run"),
        "manifest": manifest,
    }


# --------------------------------------------------------- async hand-off
class AsyncSnapshotWriter:
    """One bounded background thread running commit jobs in submission
    order.

    ``submit(job)`` enqueues a zero-argument callable and returns; when
    the queue (default depth 2) is full it blocks, so a slow disk delays
    the driver but never buffers an unbounded pile of host copies.  A
    failed job is remembered and raised (wrapped) by the next
    ``submit``/``drain``: a write error fails the run instead of
    vanishing on a daemon thread.
    """

    def __init__(self, capacity: int = 2):
        # items: (job, context), the context naming the snapshot a
        # deferred error is reported under
        self._q: "queue.Queue[Optional[tuple]]" = \
            queue.Queue(maxsize=max(1, int(capacity)))
        self._lock = threading.Lock()
        # the deferred failure: set by the writer thread, taken (and
        # cleared) by submit/drain on the driver thread
        self._error: Optional[BaseException] = None  # guarded-by: _lock
        # guarded-by: _lock
        self._error_context: Optional[str] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="ckpt-writer", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                job, context = item
                job()
            except BaseException as e:  # raised by the next submit/drain
                with self._lock:
                    self._error = e
                    self._error_context = context
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
            ctx, self._error_context = self._error_context, None
        if err is not None:
            what = f" ({ctx})" if ctx else ""
            raise RuntimeError(
                f"async checkpoint write failed{what} — training state "
                f"was NOT durably saved") from err

    def submit(self, job: Callable[[], Any],
               context: Optional[str] = None) -> None:
        """Enqueue one commit job; ``context`` ("step N -> path") names
        what a deferred failure lost."""
        if self._closed:
            raise RuntimeError("AsyncSnapshotWriter is closed")
        self._raise_pending()
        self._ensure_thread()
        self._q.put((job, context))  # blocks while the queue is full

    def pending(self) -> int:
        """Jobs submitted and not yet committed."""
        return self._q.unfinished_tasks

    def drain(self) -> None:
        """Block until every submitted job has committed; raise a
        deferred write error."""
        self._q.join()
        self._raise_pending()

    def close(self, raise_errors: bool = True) -> None:
        """Drain and stop the thread; ``raise_errors=False`` drops a
        deferred error (teardown of a run that is failing already)."""
        self._closed = True
        self._q.join()
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=30.0)
        if raise_errors:
            self._raise_pending()
        else:
            with self._lock:
                self._error = None
