"""Host-side replay of in-graph TF input pipelines (queue runners; port of
``bigdl_tpu/interop/tf_queues.py``).

A TF training GraphDef often carries its OWN input pipeline: filename
queue -> ``ReaderReadV2`` -> decode subgraph -> example queue ->
``QueueDequeueManyV2`` -> model.  The reference's session walks those
queue runners and rebuilds them; here they become a host generator:

- the dequeue node becomes the imported module's feed point;
- the enqueue side (readers, decode ops) is replayed record by record on
  the host with the same op registry the device path uses, batched to the
  dequeue's batch size.

The device never sees a queue.  Sources: TFRecord, text-line and
whole-file readers fed by a string_input_producer, identity readers, and
constant ("cached") enqueues.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.interop.tf_format import _base_name as _base

DEQUEUE_OPS = {"QueueDequeueManyV2", "QueueDequeueMany",
               "QueueDequeueUpToV2", "QueueDequeueUpTo",
               "QueueDequeueV2", "QueueDequeue"}
ENQUEUE_OPS = {"QueueEnqueueV2", "QueueEnqueue",
               "QueueEnqueueManyV2", "QueueEnqueueMany"}
QUEUE_OPS = {"FIFOQueueV2", "FIFOQueue", "RandomShuffleQueueV2",
             "RandomShuffleQueue", "PaddingFIFOQueueV2", "PaddingFIFOQueue"}
READER_OPS = {"TFRecordReaderV2": "tfrecord", "TFRecordReader": "tfrecord",
              "TextLineReaderV2": "textline", "TextLineReader": "textline",
              "WholeFileReaderV2": "wholefile",
              "WholeFileReader": "wholefile",
              "IdentityReaderV2": "identity", "IdentityReader": "identity"}



def _host_value(out):
    """An op result as a host numpy array (object arrays and other
    non-tensor values through ``np.asarray``)."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class _HostEval:
    """Evaluate a decode subgraph on host numpy values with the op
    registry (the same ops the device path executes)."""

    def __init__(self, by_name: Dict[str, dict]):
        self.by_name = by_name

    def eval(self, name: str, bind: Dict[str, object],
             memo: Optional[dict] = None):
        from bigdl_tpu_torch.ops.registry import get_op
        memo = {} if memo is None else memo

        def ev(nm):
            if nm in memo:
                return memo[nm]
            if nm in bind:
                memo[nm] = bind[nm]
                return bind[nm]
            node = self.by_name[nm]
            op = node["op"]
            if op == "Const":
                out = np.asarray(node["attrs"]["value"])
            elif op in ("Identity", "StopGradient"):
                out = arg(node["inputs"][0])
            else:
                args = [arg(i) for i in node["inputs"]
                        if not i.startswith("^")]
                out = get_op(op)(
                    {**node["attrs"], "_node_name": nm}, *args)
                if isinstance(out, tuple):
                    out = tuple(_host_value(o) for o in out)
                else:
                    out = _host_value(out)
            memo[nm] = out
            return out

        def arg(inp):
            b, ix = _base(inp)
            v = ev(b)
            return v[ix] if isinstance(v, tuple) else v

        return arg(name)


class QueuePipeline:
    """Extracted in-graph input pipeline: batches() replays it."""

    def __init__(self, nodes: List[dict], outputs: Sequence[str]):
        self.by_name = {n["name"]: n for n in nodes}
        self._eval = _HostEval(self.by_name)

        # the dequeue feeding the requested outputs (reverse BFS)
        seen, stack = set(), [_base(o)[0] for o in outputs]
        dequeue = None
        while stack:
            nm = stack.pop()
            if nm in seen or nm not in self.by_name:
                continue
            seen.add(nm)
            node = self.by_name[nm]
            if node["op"] in DEQUEUE_OPS:
                dequeue = node
                break
            stack.extend(_base(i)[0] for i in node["inputs"])
        if dequeue is None:
            raise ValueError("no QueueDequeue* op on the path to "
                             f"{list(outputs)} — not a queue-fed graph")
        self.dequeue = dequeue["name"]
        if dequeue["op"] in ("QueueDequeueManyV2", "QueueDequeueMany",
                             "QueueDequeueUpToV2", "QueueDequeueUpTo"):
            self.batch_size = int(np.asarray(
                self._eval.eval(dequeue["inputs"][1], {})).reshape(-1)[0])
        else:
            self.batch_size = 1

        # the example queue and its enqueues
        qname = _base(dequeue["inputs"][0])[0]
        self.queue = self.by_name[qname]
        if self.queue["op"] not in QUEUE_OPS:
            raise NotImplementedError(
                f"dequeue reads from op {self.queue['op']!r}, not a queue")
        self.shuffle = "RandomShuffle" in self.queue["op"]
        enq = [n for n in nodes if n["op"] in ENQUEUE_OPS
               and _base(n["inputs"][0])[0] == qname]
        if len(enq) != 1:
            raise NotImplementedError(
                f"queue {qname!r} has {len(enq)} enqueue ops; expected 1")
        self.enqueue = enq[0]
        self.enqueue_many = "Many" in self.enqueue["op"]
        self.components = [i for i in self.enqueue["inputs"][1:]
                           if not i.startswith("^")]

        # source: a reader (which file/record stream?) or pure consts
        self.read_node = self._find_reader(self.components)
        if self.read_node is not None:
            read = self.by_name[self.read_node]
            reader = self.by_name[_base(read["inputs"][0])[0]]
            self.reader_kind = READER_OPS[reader["op"]]
            self.filenames = self._filename_list(
                _base(read["inputs"][1])[0])

    def _find_reader(self, roots) -> Optional[str]:
        seen, stack = set(), [_base(r)[0] for r in roots]
        while stack:
            nm = stack.pop()
            if nm in seen or nm not in self.by_name:
                continue
            seen.add(nm)
            node = self.by_name[nm]
            if node["op"] in ("ReaderReadV2", "ReaderRead"):
                return nm
            stack.extend(_base(i)[0] for i in node["inputs"])
        return None

    def _filename_list(self, fq_name: str) -> List[str]:
        """Resolve a string_input_producer-style filename queue to its
        constant filename list."""
        node = self.by_name[fq_name]
        if node["op"] not in QUEUE_OPS:
            raise NotImplementedError(
                f"reader's filename source {fq_name!r} is {node['op']!r}")
        enq = [n for n in self.by_name.values() if n["op"] in ENQUEUE_OPS
               and _base(n["inputs"][0])[0] == fq_name]
        if not enq:
            raise NotImplementedError(
                f"filename queue {fq_name!r} has no enqueue")
        names = self._eval.eval(enq[0]["inputs"][1], {})
        out = []
        for v in np.asarray(names).reshape(-1):
            out.append(v.decode() if isinstance(v, bytes) else str(v))
        return out

    # ------------------------------------------------------------------
    def _records(self):
        """Yield per-element bindings for the enqueue components."""
        if self.read_node is None:
            # "cached" case: constant enqueue; EnqueueMany rows are the
            # elements
            vals = [np.asarray(self._eval.eval(c, {}))
                    for c in self.components]
            if self.enqueue_many:
                for i in range(vals[0].shape[0]):
                    yield [v[i] for v in vals]
            else:
                yield list(vals)
            return
        from bigdl_tpu_torch.dataset import tfrecord
        for fn in self.filenames:
            if self.reader_kind == "tfrecord":
                for rec in tfrecord.read_records(fn):
                    yield (fn.encode(), rec)
            elif self.reader_kind == "textline":
                with open(fn, "rb") as f:
                    for line in f:
                        yield (fn.encode(), line.rstrip(b"\n"))
            elif self.reader_kind == "wholefile":
                with open(fn, "rb") as f:
                    yield (fn.encode(), f.read())
            else:  # identity
                yield (fn.encode(), fn.encode())

    def _decoded_elements(self) -> list:
        """Decode the whole record stream once (deterministic host
        work); epochs reuse the cache and only reshuffle/rebatch."""
        if getattr(self, "_cache", None) is not None:
            return self._cache
        elements = []
        for rec in self._records():
            if self.read_node is None:
                elements.append(rec)
            else:
                bind = {self.read_node: (np.asarray(rec[0], object),
                                         np.asarray(rec[1], object))}
                memo: dict = {}
                elements.append([
                    np.asarray(self._eval.eval(c, bind, memo))
                    for c in self.components])
        self._cache = elements
        return elements

    def batches(self, epochs: int = 1, seed: int = 0,
                drop_remainder: Optional[bool] = None):
        """Yield feed dicts {f"{dequeue}:{i}": batched array}.

        ``drop_remainder`` defaults to the dequeue op's TF semantics:
        DequeueMany only pops full batches (tail dropped), DequeueUpTo
        allows a final partial batch."""
        if drop_remainder is None:
            drop_remainder = "UpTo" not in self.by_name[self.dequeue]["op"]
        rng = np.random.default_rng(seed)
        n_yielded = 0
        for _ in range(epochs):
            elements = list(self._decoded_elements())
            if self.shuffle:
                rng.shuffle(elements)
            for i in range(0, len(elements) - self.batch_size + 1
                           if drop_remainder else len(elements),
                           self.batch_size):
                chunk = elements[i:i + self.batch_size]
                if not chunk:
                    break
                feeds = {}
                many = self.by_name[self.dequeue]["op"] not in (
                    "QueueDequeueV2", "QueueDequeue")
                for ci in range(len(self.components)):
                    col = np.stack([e[ci] for e in chunk])
                    # a non-Many dequeue pops ONE element, unbatched
                    feeds[f"{self.dequeue}:{ci}"] = col if many else col[0]
                n_yielded += 1
                yield feeds
        if n_yielded == 0:
            raise ValueError(
                f"queue pipeline produced 0 batches: "
                f"{len(self._decoded_elements())} element(s) < batch size "
                f"{self.batch_size} (DequeueMany drops partial batches; "
                "use QueueDequeueUpToV2 or more data)")
