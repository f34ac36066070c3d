"""TensorFlow GraphDef importer (port of ``bigdl_tpu/interop/tf_format.py``).

Reads binary ``.pb`` and text ``.pbtxt`` GraphDefs with no generated
protobuf code (``utils/protowire`` for the wire, a small recursive parser
for the text), prunes the graph by a reverse DFS from the requested
outputs, and runs the pruned graph as one module over the op registry
(``bigdl_tpu_torch.ops.registry``):

- ``VariableV2`` nodes become ``nn.Parameter`` s of the module (initial
  values from their ``Assign`` initializer when it evaluates, else zeros);
- nodes that depend only on ``Const`` s are folded on the host at load;
- ``Switch``/``Merge`` (tf.cond) run both branches and select;
- each while frame (Enter/Merge/Switch/NextIteration/Exit) runs as a
  Python loop over torch tensors, nested frames as sub-loops, for the
  statically recovered trip count when there is one and until the
  condition fails otherwise; autograd runs through both.  A TensorArray
  flow entering a loop with its element shape unknown is allocated by
  probing the body once.

The module is built on the CPU; ``.to(device)`` moves its variables, and
its float constants follow the input's device.
"""

from __future__ import annotations

import re
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.interop.tf_loops import extract_frames, static_trip_count
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.registry import TAPending, _t, _tt, get_op
from bigdl_tpu_torch.utils import protowire as pw

# tensorflow DataType enum values
_DT_NP = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8,
          5: np.int16, 6: np.int8, 7: np.bytes_, 9: np.int64, 10: np.bool_}


# ===========================================================================
# binary GraphDef decode
# ===========================================================================
def _decode_tensor_proto(m: Dict[int, list]) -> np.ndarray:
    dtype = int(m.get(1, [1])[0])
    np_dt = _DT_NP.get(dtype, np.float32)
    shape: List[int] = []
    if 2 in m:
        sm = pw.decode_message(m[2][0])
        for dim in sm.get(2, []):
            dm = pw.decode_message(dim)
            shape.append(pw.as_sint(dm.get(1, [0])[0]))
    if 4 in m and m[4][0]:
        arr = np.frombuffer(m[4][0], dtype=np_dt)
    elif dtype == 1 and 5 in m:
        vals = []
        for v in m[5]:
            vals.extend(pw.unpack_packed(v, "float")
                        if isinstance(v, bytes) else [pw.as_float(v)])
        arr = np.asarray(vals, np.float32)
    elif dtype == 2 and 6 in m:
        vals = []
        for v in m[6]:
            vals.extend(pw.unpack_packed(v, "double")
                        if isinstance(v, bytes) else [pw.as_double(v)])
        arr = np.asarray(vals, np.float64)
    elif dtype in (3, 4, 5, 6) and 7 in m:
        arr = np.asarray([pw.as_sint(v) for v in pw.ints(m, 7)], np_dt)
    elif dtype == 9 and 10 in m:
        arr = np.asarray([pw.as_sint(v) for v in pw.ints(m, 10)], np.int64)
    elif dtype == 10 and 11 in m:
        arr = np.asarray(pw.ints(m, 11), np.bool_)
    elif dtype == 7 and 8 in m:
        return np.asarray(m[8], object)
    else:
        arr = np.zeros(0, np_dt)
    n = int(np.prod(shape)) if shape else arr.size
    if arr.size == 1 and n > 1:   # splat-encoded constant
        arr = np.full(n, arr[0], arr.dtype)
    return arr.reshape(shape) if shape else (
        arr.reshape(()) if arr.size == 1 else arr)


def _decode_attr_value(data: bytes) -> Any:
    m = pw.decode_message(data)
    if 2 in m:
        return m[2][0]                       # s (bytes)
    if 3 in m:
        return pw.as_sint(m[3][0])           # i
    if 4 in m:
        return pw.as_float(m[4][0])          # f
    if 5 in m:
        return bool(m[5][0])                 # b
    if 6 in m:
        return int(m[6][0])                  # type enum
    if 8 in m:
        return _decode_tensor_proto(pw.decode_message(m[8][0]))  # tensor
    if 7 in m:
        sm = pw.decode_message(m[7][0])      # shape
        dims = []
        for dim in sm.get(2, []):
            dm = pw.decode_message(dim)
            dims.append(pw.as_sint(dm.get(1, [0])[0]))
        return dims
    if 1 in m:                               # list
        lm = pw.decode_message(m[1][0])
        if 3 in lm:
            return [pw.as_sint(v) for v in pw.ints(lm, 3)]
        if 4 in lm:
            out = []
            for v in lm[4]:
                out.extend(pw.unpack_packed(v, "float")
                           if isinstance(v, bytes) else [pw.as_float(v)])
            return out
        if 2 in lm:
            return list(lm[2])
        if 5 in lm:
            return [bool(v) for v in pw.ints(lm, 5)]
        if 7 in lm:                          # list(shape) — ParseExample
            out = []
            for sh in lm[7]:
                sm2 = pw.decode_message(sh)
                out.append([pw.as_sint(pw.decode_message(d).get(1, [0])[0])
                            for d in sm2.get(2, [])])
            return out
        return []
    return None


def parse_graphdef_binary(data: bytes) -> List[dict]:
    g = pw.decode_message(data)
    nodes = []
    for nd in g.get(1, []):
        m = pw.decode_message(nd)
        attrs = {}
        for e in m.get(5, []):
            em = pw.decode_message(e)
            attrs[pw.as_str(em[1][0])] = _decode_attr_value(em[2][0])
        nodes.append({
            "name": pw.as_str(m[1][0]),
            "op": pw.as_str(m[2][0]) if 2 in m else "",
            "inputs": [pw.as_str(v) for v in m.get(3, [])],
            "attrs": attrs,
        })
    return nodes


# ===========================================================================
# text GraphDef (.pbtxt) decode
# ===========================================================================
_TOKEN = re.compile(
    r'\s*(?:(#[^\n]*)|([A-Za-z_][A-Za-z0-9_]*)|("(?:\\.|[^"\\])*")'
    r"|([{}:])|(-?[0-9][0-9eE+\-.]*)|(-inf|inf|nan))")


def _tokenize(text: str):
    pos = 0
    n = len(text)
    while pos < n:
        mt = _TOKEN.match(text, pos)
        if not mt:
            if text[pos:].strip() == "":
                return
            raise ValueError(f"pbtxt parse error at {text[pos:pos+40]!r}")
        pos = mt.end()
        if mt.group(1):
            continue  # comment
        yield mt.group(0).strip()


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "'": "'",
            "\\": "\\", "a": "\a", "b": "\b", "f": "\f", "v": "\v"}


def _unescape(s: str) -> bytes:
    """C-style escaped text-proto string → bytes."""
    out = bytearray()
    i = 0
    while i < len(s):
        c = s[i]
        if c != "\\":
            out.extend(c.encode("utf-8", "surrogateescape"))
            i += 1
            continue
        i += 1
        c = s[i]
        if c in _ESCAPES:
            out.append(ord(_ESCAPES[c]))
            i += 1
        elif c in "01234567":
            oct_digits = s[i:i + 3]
            j = 1
            while j < 3 and j < len(oct_digits) and oct_digits[j] in \
                    "01234567":
                j += 1
            out.append(int(s[i:i + j], 8))
            i += j
        elif c == "x":
            out.append(int(s[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(ord(c))
            i += 1
    return bytes(out)


def _parse_textproto(tokens) -> dict:
    """Parse one message body; repeated keys collect into lists."""
    msg: Dict[str, list] = {}
    for tok in tokens:
        if tok == "}":
            return msg
        key = tok
        nxt = next(tokens)
        if nxt == "{":
            val = _parse_textproto(tokens)
        elif nxt == ":":
            v = next(tokens)
            if v == "{":
                val = _parse_textproto(tokens)
            elif v.startswith('"'):
                val = _unescape(v[1:-1])
            elif v in ("true", "false"):
                val = v == "true"
            else:
                try:
                    val = int(v)
                except ValueError:
                    try:
                        val = float(v)
                    except ValueError:
                        val = v  # enum name (DT_FLOAT etc.)
        else:
            raise ValueError(f"unexpected token {nxt!r} after {key!r}")
        msg.setdefault(key, []).append(val)
    return msg


_DT_NAMES = {"DT_FLOAT": 1, "DT_DOUBLE": 2, "DT_INT32": 3, "DT_UINT8": 4,
             "DT_INT16": 5, "DT_INT8": 6, "DT_STRING": 7, "DT_INT64": 9,
             "DT_BOOL": 10}


def _text_tensor(t: dict) -> np.ndarray:
    dtype = _DT_NAMES.get(t.get("dtype", ["DT_FLOAT"])[0], 1)
    np_dt = _DT_NP.get(dtype, np.float32)
    shape: List[int] = []
    for sh in t.get("tensor_shape", []):
        for dim in sh.get("dim", []):
            shape.append(int(dim.get("size", [0])[0]))
    if "tensor_content" in t:
        arr = np.frombuffer(t["tensor_content"][0], dtype=np_dt)
    elif "float_val" in t:
        arr = np.asarray([float(v) for v in t["float_val"]], np.float32)
    elif "int_val" in t:
        arr = np.asarray([int(v) for v in t["int_val"]], np_dt)
    elif "int64_val" in t:
        arr = np.asarray([int(v) for v in t["int64_val"]], np.int64)
    elif "double_val" in t:
        arr = np.asarray([float(v) for v in t["double_val"]], np.float64)
    elif "bool_val" in t:
        arr = np.asarray(t["bool_val"], np.bool_)
    elif "string_val" in t:
        return np.asarray(t["string_val"], object)
    else:
        arr = np.zeros(0, np_dt)
    n = int(np.prod(shape)) if shape else arr.size
    if arr.size == 1 and n > 1:
        arr = np.full(n, arr[0], arr.dtype)
    return arr.reshape(shape) if shape else (
        arr.reshape(()) if arr.size == 1 else arr)


def _text_attr(v: dict) -> Any:
    if "s" in v:
        return v["s"][0]
    if "i" in v:
        return int(v["i"][0])
    if "f" in v:
        return float(v["f"][0])
    if "b" in v:
        return bool(v["b"][0])
    if "type" in v:
        return _DT_NAMES.get(v["type"][0], 1)
    if "tensor" in v:
        return _text_tensor(v["tensor"][0])
    if "shape" in v:
        dims = []
        for dim in v["shape"][0].get("dim", []):
            dims.append(int(dim.get("size", [0])[0]))
        return dims
    if "list" in v:
        lv = v["list"][0]
        for k in ("i", "f", "s", "b"):
            if k in lv:
                return [int(x) if k == "i" else x for x in lv[k]]
        return []
    return None


def parse_graphdef_text(text: str) -> List[dict]:
    root = _parse_textproto(_tokenize(text))
    nodes = []
    for nd in root.get("node", []):
        attrs = {}
        for a in nd.get("attr", []):
            key = a["key"][0]
            key = key.decode() if isinstance(key, bytes) else key
            attrs[key] = _text_attr(a["value"][0])
        name = nd["name"][0]
        op = nd["op"][0]
        nodes.append({
            "name": name.decode() if isinstance(name, bytes) else name,
            "op": op.decode() if isinstance(op, bytes) else op,
            "inputs": [i.decode() if isinstance(i, bytes) else i
                       for i in nd.get("input", [])],
            "attrs": attrs,
        })
    return nodes


# ===========================================================================
# graph build + execution
# ===========================================================================
def _base_name(inp: str) -> Tuple[str, int]:
    """'node:2' → ('node', 2); '^ctrl' → ('ctrl', -1)."""
    if inp.startswith("^"):
        return inp[1:], -1
    if ":" in inp:
        name, ix = inp.rsplit(":", 1)
        return name, int(ix)
    return inp, 0




# ------------------------------------------------ control flow (tf.cond)
# Switch tags each branch's values with (predicate, branch) provenance and
# Merge selects with ``torch.where(pred, true_val, false_val)``: both
# branches run.
class _Tagged:
    """A value that flowed through a Switch branch; ``tags`` maps the
    predicate node name → (pred tensor, branch bool)."""

    __slots__ = ("value", "tags")

    def __init__(self, value, tags):
        self.value = value
        self.tags = tags


def _tag_value(a):
    return a.value if isinstance(a, _Tagged) else a


def _union_tags(args) -> dict:
    tags: dict = {}
    for a in args:
        if isinstance(a, _Tagged):
            tags.update(a.tags)
    return tags


def _exec_switch(args, pred_name: str):
    data, pred = args[0], args[1]
    base = _union_tags(args)
    d, p = _tag_value(data), _tag_value(pred)
    false_out = _Tagged(d, {**base, pred_name: (p, False)})
    true_out = _Tagged(d, {**base, pred_name: (p, True)})
    return (false_out, true_out)  # TF Switch ports: 0=false, 1=true


def _exec_merge(args):
    tagged = [a for a in args if isinstance(a, _Tagged)]
    keys: set = set()
    for t in tagged:
        keys |= set(t.tags)
    for key in keys:
        branches = {}
        for a in tagged:
            if key in a.tags:
                branches[a.tags[key][1]] = a
        if True in branches and False in branches:
            pred, tv, fv = _tt(branches[True].tags[key][0],
                               _tag_value(branches[True]),
                               _tag_value(branches[False]))
            sel = torch.where(pred.bool(), tv, fv)
            rest = _union_tags(tagged)
            rest.pop(key, None)
            out = _Tagged(sel, rest) if rest else sel
            return (out, torch.zeros((), dtype=torch.int32))
    if len(args) == 1:  # one live input (the other side pruned)
        return (args[0], torch.zeros((), dtype=torch.int32))
    raise NotImplementedError(
        "Merge whose inputs don't trace to complementary Switch branches")


def _host(out):
    """An op's result kept on the host: numpy where numpy has the type."""
    if isinstance(out, tuple):
        return tuple(_host(o) for o in out)
    if isinstance(out, torch.Tensor) and out.dtype != torch.bfloat16:
        return out.detach().cpu().numpy()
    return out


def _param_name(tf_name: str) -> str:
    # torch parameter names may not hold "."
    return tf_name.replace(".", "_dot_")


_SOURCES = ("Placeholder", "PlaceholderV2")
_VARIABLES = ("VariableV2", "Variable")


class TFGraphModule(Module):
    """An imported graph as a module.

    - parameters: the VariableV2 nodes (named by node name, ``.`` written
      ``_dot_``), initialized from their Assign initializer when it
      evaluates, else zeros;
    - ``forward(input)``: runs the pruned graph; ``input`` is one tensor
      (a single placeholder) or a dict {placeholder name: tensor}, a name
      optionally port-suffixed (``"x:0"``; several ports of one node
      assemble a tuple).
    """

    def __init__(self, nodes: List[dict], inputs: Sequence[str],
                 outputs: Sequence[str], name: Optional[str] = None):
        super().__init__(name)
        self.by_name = {n["name"]: n for n in nodes}
        self.input_names = list(inputs)
        self.output_names = list(outputs)
        self._var_init: Dict[str, np.ndarray] = {}
        self._const_cache: Dict[Tuple[str, str], torch.Tensor] = {}
        # while frames (Enter/Merge/Switch/Exit wiring; interop/tf_loops.py)
        self._frames = extract_frames(nodes)
        self._node_frame: Dict[str, Any] = {}
        for fr in self._frames.values():
            for nm in fr.interior:
                self._node_frame[nm] = fr

        # prune: reverse DFS from the outputs.  Nodes named in ``inputs``
        # are feed points whatever their op (a queue or reader source is
        # replaced by a fed endpoint).
        feed_points = {_base_name(i)[0] for i in inputs}
        needed: List[str] = []
        seen = set()
        stack = [_base_name(o)[0] for o in outputs]
        while stack:
            nm = stack.pop()
            if nm in seen:
                continue
            seen.add(nm)
            node = self.by_name.get(nm)
            if node is None:
                raise KeyError(f"graph has no node {nm!r}")
            needed.append(nm)
            if node["op"] in _SOURCES or nm in feed_points:
                continue
            if nm in self._node_frame:
                err = self._node_frame[nm].nest_error()
                if err:
                    raise NotImplementedError(err)
            if node["op"] == "Exit" and nm in self._node_frame:
                # the whole frame nest and every external input it reads
                fr = self._node_frame[nm]
                for inm in fr.all_interior():
                    if inm not in seen:
                        seen.add(inm)
                        needed.append(inm)
                stack.extend(fr.all_externals())
                continue
            for inp in node["inputs"]:
                b, ix = _base_name(inp)
                if ix >= 0:   # control dependencies are skipped
                    stack.append(b)
        self.needed = set(needed)
        self.feed_points = feed_points

        # the variables' initial values through their Assign nodes
        assigns = {}
        for n in nodes:
            if n["op"] == "Assign" and n["inputs"]:
                assigns[_base_name(n["inputs"][0])[0]] = \
                    _base_name(n["inputs"][1])[0]
        for nm in sorted(self.needed):
            node = self.by_name[nm]
            if node["op"] in _VARIABLES:
                init = self._try_const_eval(assigns[nm]) \
                    if nm in assigns else None
                if init is None:
                    init = np.zeros([int(d) for d in
                                     node["attrs"].get("shape", [])],
                                    np.float32)
                self._var_init[nm] = np.asarray(init, np.float32)
                self.register_parameter(_param_name(nm), torch.nn.Parameter(
                    torch.from_numpy(self._var_init[nm].copy()),
                    requires_grad=False))

        # topological order over the pruned subgraph
        order: List[str] = []
        state: Dict[str, int] = {}

        def visit(nm: str):
            st = state.get(nm)
            if st == 2:
                return
            if st == 1:
                raise ValueError(f"cycle through {nm} outside a while "
                                 "frame")
            state[nm] = 1
            node = self.by_name[nm]
            fr = self._node_frame.get(nm)
            top_exit = (fr is not None and node["op"] == "Exit"
                        and fr.parent is None)
            if top_exit:
                # an Exit depends on every EXTERNAL input of its nest
                for b in fr.all_externals():
                    if b in self.needed:
                        visit(b)
            elif fr is not None:
                pass  # interior nodes run inside the frame's loop
            elif node["op"] not in _SOURCES + _VARIABLES + ("Const",) \
                    and nm not in self.feed_points:
                for inp in node["inputs"]:
                    b, ix = _base_name(inp)
                    if ix >= 0 and b in self.needed:
                        visit(b)
            state[nm] = 2
            if fr is None or top_exit:
                order.append(nm)

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10 * len(self.needed) + 100))
        try:
            for o in outputs:
                visit(_base_name(o)[0])
        finally:
            sys.setrecursionlimit(old)
        # a loop-INTERIOR output cannot be read after the loop
        for o in outputs:
            b = _base_name(o)[0]
            fr = self._node_frame.get(b)
            if fr is not None and (self.by_name[b]["op"] != "Exit"
                                   or fr.parent is not None):
                raise NotImplementedError(
                    f"output {o!r} is inside while frame {fr.name!r}; "
                    "only Exit values of a TOP-LEVEL loop are addressable")
        self.order = order
        self._fold_constants()

    def _fold_constants(self) -> None:
        """Evaluate every node that depends only on Consts once, on the
        host, at load: shape computations (Shape→Slice→Pack→Reshape) then
        reach the ops that need static values as host arrays."""
        folded: Dict[str, Any] = {}
        dynamic_ops = set(_SOURCES + _VARIABLES) | {
            "RandomUniform", "RandomStandardNormal", "TruncatedNormal"}
        for nm in self.order:
            node = self.by_name[nm]
            op = node["op"]
            if op == "Const":
                folded[nm] = np.asarray(node["attrs"]["value"])
                continue
            if op in dynamic_ops or nm in self.feed_points \
                    or nm in self._node_frame \
                    or op.startswith("TensorArray"):
                # TensorArray ops produce handle/flow objects
                continue
            args = []
            ok = True
            for inp in node["inputs"]:
                b, ix = _base_name(inp)
                if ix < 0:
                    continue
                if b not in folded:
                    ok = False
                    break
                v = folded[b]
                args.append(v[ix] if isinstance(v, tuple) else v)
            if not ok:
                continue
            try:
                out = get_op(op)({**node["attrs"], "_node_name": nm}, *args)
            except NotImplementedError:
                continue
            folded[nm] = _host(out)
        self._folded = folded

    def _try_const_eval(self, nm: str, depth: int = 0):
        """Evaluate an initializer subgraph on the host — Consts and any
        registered op, the random ones included (node-seeded), so a
        variable gets real initial values — or None."""
        if depth > 32:
            return None
        node = self.by_name.get(nm)
        if node is None or node["op"].startswith("TensorArray"):
            return None
        if node["op"] == "Const":
            return np.asarray(node["attrs"]["value"])
        args = []
        for inp in node["inputs"]:
            b, ix = _base_name(inp)
            if ix < 0:
                continue
            v = self._try_const_eval(b, depth + 1)
            if v is None:
                return None
            args.append(v)
        try:
            out = get_op(node["op"])(
                {**node["attrs"], "_node_name": nm}, *args)
        except Exception:
            return None
        return None if isinstance(out, tuple) else _host(out)

    def reset_parameters(self, generator):
        # a graph's variables start from their initializers, not a draw
        for nm, init in self._var_init.items():
            getattr(self, _param_name(nm)).data.copy_(torch.from_numpy(init))

    def _const(self, nm: str, device: torch.device):
        """A folded value as the graph uses it: float arrays as tensors on
        ``device`` (cached), integer and other arrays on the host."""
        v = self._folded[nm]
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            key = (nm, str(device))
            t = self._const_cache.get(key)
            if t is None:
                t = self._const_cache[key] = _t(v, device)
            return t
        return v

    # ----------------------------------------------------- while frames
    def _eval_interior(self, fr, bind, values, target: str, device,
                       memo: Optional[Dict[str, Any]] = None):
        """Evaluate interior node ``target`` with Merge/invariant-Enter
        nodes bound by ``bind`` and exterior values from ``values``.  One
        ``memo`` across the targets of one trip evaluates shared body
        subgraphs once."""
        if memo is None:
            memo = {}

        def ev(nm: str):
            if nm in memo:
                return memo[nm]
            if nm in bind:
                memo[nm] = bind[nm]
                return bind[nm]
            if nm not in fr.interior:
                sub = self._node_frame.get(nm)
                if sub is not None and sub is not fr \
                        and sub.parent is not None:
                    # a NESTED frame's Exit: run the child loop, its outer
                    # inputs resolved through this evaluation
                    err = sub.nest_error()
                    if err:
                        raise NotImplementedError(err)

                    class _Ctx:
                        def __getitem__(_self, key):
                            if key in memo or key in bind \
                                    or key in fr.interior:
                                return ev(key)
                            return values[key]

                        def __setitem__(_self, key, val):
                            memo[key] = val

                    self._run_frame(sub, _Ctx(), device)
                    return memo[nm]
                return values[nm]  # port/tag handling at the consumer
            node = self.by_name[nm]
            op = node["op"]
            if op == "Merge":
                raise NotImplementedError(
                    f"unbound Merge {nm} in while frame {fr.name}")
            if op in ("Switch", "LoopCond", "Identity", "NextIteration",
                      "Enter"):
                b0, ix0 = _base_name(node["inputs"][0])
                out = ev(b0)
                out = out[ix0] if isinstance(out, tuple) else out
                memo[nm] = out
                return out
            args = []
            for inp in node["inputs"]:
                b, ix = _base_name(inp)
                if ix < 0:
                    continue
                v = ev(b)
                v = v[ix] if isinstance(v, tuple) else v
                args.append(_tag_value(v))
            out = get_op(op)({**node["attrs"], "_node_name": nm}, *args)
            memo[nm] = out
            return out

        b, ix = _base_name(target)
        v = ev(b)
        v = v[ix] if isinstance(v, tuple) else v
        return _tag_value(v)

    def _run_frame(self, fr, values, device) -> None:
        """Run one while frame as a Python loop; store every Exit's value
        into ``values``."""
        def outer_value(inp: str):
            b, ix = _base_name(inp)
            v = values[b]
            v = v[ix] if isinstance(v, tuple) else v
            return _tag_value(v)

        invariant_bind = {inv["name"]: outer_value(inv["inputs"][0])
                          for inv in fr.invariants}

        # each NextIteration by its loop variable (through its Merge)
        nextit_of_merge = {}
        for m, e in zip(fr.merges, fr.enters):
            for inp in m["inputs"]:
                bse = _base_name(inp)[0]
                if bse != e["name"]:
                    nextit_of_merge[m["name"]] = self.by_name[bse]

        # the initial carry: the Enter inputs' outer values.  A
        # TensorArray flow with its element shape unknown (TAPending) is
        # allocated by probing the body once: the write inside allocates
        # storage whose shape and dtype seed a zero carry.
        raw0 = [outer_value(e["inputs"][0]) for e in fr.enters]
        if any(isinstance(v, TAPending) for v in raw0):
            probe_bind = dict(invariant_bind)
            for m, c in zip(fr.merges, raw0):
                probe_bind[m["name"]] = c
            probe_memo: Dict[str, Any] = {}
            for i, (m, v) in enumerate(zip(fr.merges, raw0)):
                if not isinstance(v, TAPending):
                    continue
                ni = nextit_of_merge.get(m["name"])
                if ni is None:
                    raise NotImplementedError(
                        f"TensorArray flow {m['name']} is never written "
                        "inside its loop; element shape unknown")
                out = self._eval_interior(fr, probe_bind, values,
                                          ni["inputs"][0], device,
                                          probe_memo)
                raw0[i] = torch.zeros_like(_t(out, device))
        carry = tuple(_t(v, device) for v in raw0)

        def bindings(carry):
            bind = dict(invariant_bind)
            for m, c in zip(fr.merges, carry):
                bind[m["name"]] = c
            return bind

        def cond(carry) -> bool:
            b = self._eval_interior(fr, bindings(carry), values,
                                    fr.loop_cond["inputs"][0], device)
            return bool(_t(b).reshape(()))

        def body(carry):
            bind = bindings(carry)
            memo: Dict[str, Any] = {}
            outs = []
            for m, c in zip(fr.merges, carry):
                ni = nextit_of_merge.get(m["name"])
                if ni is None:
                    outs.append(c)
                    continue
                v = self._eval_interior(fr, bind, values, ni["inputs"][0],
                                        device, memo)
                outs.append(_t(v, c.device).to(c.dtype).reshape(c.shape))
            return tuple(outs)

        n_trip = static_trip_count(fr, self.by_name, self._try_const_eval)
        if n_trip is not None:
            for _ in range(n_trip):
                carry = body(carry)
        else:
            while cond(carry):
                carry = body(carry)

        # each Exit's input chains (through Switch:0) to a Merge
        merge_ix = {m["name"]: i for i, m in enumerate(fr.merges)}
        for ex in fr.exits:
            nm = _base_name(ex["inputs"][0])[0]
            hops = 0
            while nm not in merge_ix and hops < 16:
                nm = _base_name(self.by_name[nm]["inputs"][0])[0]
                hops += 1
            if nm not in merge_ix:
                raise NotImplementedError(
                    f"Exit {ex['name']} does not trace to a loop variable")
            values[ex["name"]] = carry[merge_ix[nm]]

    # ---------------------------------------------------------------- API
    def _feeds(self, input) -> Dict[str, Any]:
        if not isinstance(input, dict):
            if len(self.input_names) != 1:
                raise ValueError(
                    f"graph has inputs {self.input_names}; feed a dict")
            return {_base_name(self.input_names[0])[0]: _t(input)}
        # 'x' or port-suffixed 'x:0'; several ports of one node ('parse',
        # 'parse:1' — the ParseExample idiom) assemble a tuple
        port_feeds: Dict[str, Dict[int, Any]] = {}
        for k, v in input.items():
            b, ix = _base_name(k)
            port_feeds.setdefault(b, {})[max(ix, 0)] = v

        def feed(v):
            return v if isinstance(v, np.ndarray) and v.dtype == object \
                else _t(v)

        feeds: Dict[str, Any] = {}
        for b, pf in port_feeds.items():
            if len(pf) == 1 and 0 in pf:
                feeds[b] = feed(pf[0])
            else:
                hi = max(pf)
                missing = [i for i in range(hi + 1) if i not in pf]
                if missing:
                    raise ValueError(f"feed {b!r}: ports {missing} not fed "
                                     f"(got {sorted(pf)})")
                feeds[b] = tuple(feed(pf[i]) for i in range(hi + 1))
        return feeds

    def forward(self, input):
        feeds = self._feeds(input)
        device = next((v.device for v in feeds.values()
                       if isinstance(v, torch.Tensor)), None)
        if device is None:
            device = next((p.device for p in self.parameters()),
                          torch.device("cpu"))
        values: Dict[str, Any] = {}
        for nm in self.order:
            node = self.by_name[nm]
            op = node["op"]
            if op in _SOURCES or nm in self.feed_points:
                values[nm] = feeds[nm]
            elif nm in self._folded:
                values[nm] = self._const(nm, device)
            elif op in _VARIABLES:
                values[nm] = getattr(self, _param_name(nm))
            elif op == "Exit" and nm in self._node_frame:
                if nm not in values:  # the first Exit runs the whole frame
                    self._run_frame(self._node_frame[nm], values, device)
            else:
                args = []
                for inp in node["inputs"]:
                    b, ix = _base_name(inp)
                    if ix < 0:
                        continue
                    v = values[b]
                    args.append(v[ix] if isinstance(v, tuple) else v)
                if op in ("Enter", "Exit", "NextIteration", "LoopCond"):
                    raise NotImplementedError(
                        f"stray while-frame op {op!r} ({nm}) outside a "
                        "recognized loop frame")
                if op == "Switch":
                    values[nm] = _exec_switch(
                        args, _base_name(node["inputs"][1])[0])
                elif op == "Merge":
                    values[nm] = _exec_merge(args)
                else:
                    raw = [_tag_value(a) for a in args]
                    tags = _union_tags(args)
                    out = get_op(op)(
                        {**node["attrs"], "_node_name": nm}, *raw)
                    if not tags:
                        values[nm] = out
                    elif isinstance(out, tuple):
                        # each port tagged, so a consumer's v[ix] works
                        values[nm] = tuple(_Tagged(o, tags) for o in out)
                    else:
                        values[nm] = _Tagged(out, tags)
        outs = []
        for o in self.output_names:
            b, ix = _base_name(o)
            v = values[b]
            v = _tag_value(v[ix] if isinstance(v, tuple) else v)
            if not (isinstance(v, np.ndarray) and v.dtype == object):
                v = _t(v, device)
            outs.append(v)
        return outs[0] if len(outs) == 1 else tuple(outs)


def load_tf_graph(path: str, inputs: Sequence[str],
                  outputs: Sequence[str]) -> TFGraphModule:
    """Load a GraphDef (binary ``.pb`` or text ``.pbtxt``) as the module
    of the subgraph ``inputs`` → ``outputs``, on the CPU (the reference's
    ``Module.loadTF``)."""
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".pbtxt") or path.endswith(".txt"):
        nodes = parse_graphdef_text(data.decode("utf-8"))
    else:
        nodes = parse_graphdef_binary(data)
    return TFGraphModule(nodes, inputs, outputs)
