"""TF v1 while-loop frame reconstruction (port of
``bigdl_tpu/interop/tf_loops.py``; numpy only).

The v1 wiring per loop variable is

    outer ──Enter(frame)──▶ Merge ◀── NextIteration ◀── body value
                              │
                              ├──▶ (cond subgraph) ──▶ LoopCond
                              ▼
                           Switch(data, LoopCond)
                        port0=false ▶ Exit ▶ downstream
                        port1=true  ▶ (body subgraph)

so: carry = Merge values; ``cond`` evaluates the LoopCond input with the
merges bound to the carry; ``body`` evaluates each NextIteration input
the same way; Exit yields the final carry.  Loop-invariant Enters (no
Merge consumer) bind straight to their outer value.

**Nesting** (BigDL's ``FrameManager`` parent/child frames): each node is
owned by its INNERMOST frame; a parent's body evaluator runs a child
frame as one sub-loop when the child's Exit value is demanded
(``tf_format.TFGraphModule._eval_interior``).

:func:`extract_frames` groups a GraphDef's nodes by the Enter
``frame_name`` attr, builds the parent/child hierarchy and returns each
frame's wiring; :func:`static_trip_count` recovers a trip count from the
canonical counter pattern.  The executor in ``tf_format`` runs a frame as
a Python loop over torch tensors (autograd runs through it either way).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _attr_frame(node) -> Optional[str]:
    f = node["attrs"].get("frame_name")
    if isinstance(f, bytes):
        return f.decode()
    return f


class LoopFrame:
    """Wiring of one while-loop frame."""

    __slots__ = ("name", "interior", "enters", "merges", "switches",
                 "exits", "next_iterations", "loop_cond", "invariants",
                 "error", "externals", "parent", "children")

    def __init__(self, name: str):
        self.name = name
        self.externals: set = set()     # node names OUTSIDE the frame
        # that interior nodes read (the frame's data dependencies);
        # for a nested frame these include parent-interior names
        self.error: Optional[str] = None  # set instead of raising so an
        # UNREACHABLE malformed frame never blocks loading; the executor
        # raises only if a pruned path actually needs this frame
        self.interior: set = set()      # node names owned by THIS frame
        # (descendants' nodes excluded — innermost owner wins)
        self.enters: List[dict] = []
        self.merges: List[dict] = []    # aligned with loop-var enters
        self.switches: List[dict] = []
        self.exits: List[dict] = []
        self.next_iterations: List[dict] = []
        self.loop_cond: Optional[dict] = None
        self.invariants: List[dict] = []  # Enters with no Merge consumer
        self.parent: Optional["LoopFrame"] = None
        self.children: List["LoopFrame"] = []

    # -------------------------------------------------- nest aggregates
    def descendants(self) -> List["LoopFrame"]:
        out = []
        stack = list(self.children)
        while stack:
            f = stack.pop()
            out.append(f)
            stack.extend(f.children)
        return out

    def all_interior(self) -> set:
        out = set(self.interior)
        for d in self.descendants():
            out |= d.interior
        return out

    def all_externals(self) -> set:
        """External deps of the whole nest: union of per-frame externals
        minus every name owned inside the nest."""
        nest = self.all_interior()
        out = set(self.externals)
        for d in self.descendants():
            out |= d.externals
        return out - nest

    def nest_error(self) -> Optional[str]:
        if self.error:
            return self.error
        for d in self.descendants():
            if d.error:
                return d.error
        return None


def extract_frames(nodes: List[dict]) -> Dict[str, LoopFrame]:
    """Group control-flow nodes into frames (innermost ownership),
    recover per-variable wiring, and link parent/child frames.
    Unsupported shapes (missing LoopCond, odd merge wiring) set
    ``frame.error`` rather than raising, so they only fail if the
    requested outputs actually reach them."""
    by_name = {n["name"]: n for n in nodes}
    consumers: Dict[str, List[dict]] = {}
    for n in nodes:
        for inp in n["inputs"]:
            base = inp.split(":")[0].lstrip("^")
            consumers.setdefault(base, []).append(n)

    frames: Dict[str, LoopFrame] = {}
    frame_enters: Dict[str, List[dict]] = {}
    for n in nodes:
        if n["op"] == "Enter":
            fname = _attr_frame(n) or "frame"
            frames.setdefault(fname, LoopFrame(fname))
            frame_enters.setdefault(fname, []).append(n)

    # each Exit belongs to the frame its data chain entered: walk
    # Switch→Merge→Enter along input[0] to the Enter's frame_name
    def exit_frame(ex_node) -> Optional[str]:
        nm = ex_node["inputs"][0].split(":")[0]
        for _ in range(32):
            n = by_name.get(nm)
            if n is None or not n["inputs"] and n["op"] != "Enter":
                return None
            if n["op"] == "Enter":
                return _attr_frame(n) or "frame"
            nm = n["inputs"][0].split(":")[0]
        return None

    # ---- phase 1: flood each frame forward from its Enters, stopping
    # only at the frame's OWN Exits (a nested frame's Exit feeds nodes
    # that still belong to this frame)
    flood: Dict[str, set] = {}
    for fname, enters in frame_enters.items():
        stack = [e["name"] for e in enters]
        seen = set(stack)
        while stack:
            nm = stack.pop()
            node = by_name[nm]
            if node["op"] == "Exit" and exit_frame(node) == fname:
                continue
            for c in consumers.get(nm, []):
                if c["name"] not in seen:
                    seen.add(c["name"])
                    stack.append(c["name"])
        flood[fname] = seen

    # ---- phase 2: hierarchy (innermost ownership).  Frame B is nested
    # in A iff B's Enters lie inside A's flood; the innermost parent is
    # the candidate with the smallest flood.
    for bname, benters in frame_enters.items():
        # ANY enter inside A's flood marks nesting (loop-var enters whose
        # init is outer-frame data are flooded; counter enters fed by
        # consts are not)
        bnames = {e["name"] for e in benters}
        cands = [a for a in frames
                 if a != bname and (bnames & flood[a])]
        if cands:
            parent = min(cands, key=lambda a: len(flood[a]))
            frames[bname].parent = frames[parent]
            frames[parent].children.append(frames[bname])
    owner: Dict[str, str] = {}
    for fname in frames:
        others = set()
        for oname in frames:
            if oname != fname and frames[oname].parent is not None:
                # any frame nested (transitively) under fname claims its
                # nodes away from fname
                p = frames[oname]
                anc = p.parent
                while anc is not None:
                    if anc.name == fname:
                        others |= flood[oname]
                        break
                    anc = anc.parent
        frames[fname].interior = flood[fname] - others
        for nm in frames[fname].interior:
            owner[nm] = fname

    # ---- phase 3: per-frame classification over owned nodes
    for fname, frame in frames.items():
        for nm in frame.interior:
            node = by_name[nm]
            for inp in node["inputs"]:
                base = inp.split(":")[0]
                if base.startswith("^") or base in frame.interior:
                    continue
                own = owner.get(base)
                if own is not None and frames[own].parent is not None:
                    # owned by a DESCENDANT frame (child Exit): internal
                    # to the nest, resolved by the parent's evaluator
                    anc = frames[own].parent
                    nested = False
                    while anc is not None:
                        if anc is frame:
                            nested = True
                            break
                        anc = anc.parent
                    if nested:
                        continue
                frame.externals.add(base)
            op = node["op"]
            if op == "Merge":
                frame.merges.append(node)
            elif op == "Switch":
                frame.switches.append(node)
            elif op == "Exit":
                frame.exits.append(node)
            elif op == "NextIteration":
                frame.next_iterations.append(node)
            elif op == "LoopCond":
                frame.loop_cond = node

        # classify enters: loop variables feed a Merge; invariants don't
        enters = frame_enters[fname]
        merge_inputs = {inp.split(":")[0]
                        for m in frame.merges for inp in m["inputs"]}
        loop_vars = []
        for e in enters:
            (loop_vars if e["name"] in merge_inputs
             else frame.invariants).append(e)
        frame.enters = loop_vars
        if frame.loop_cond is None:
            frame.error = frame.error or (
                f"while frame {frame.name!r} has no LoopCond")
            continue

        # order merges to match their enter (merge inputs: [enter, nextit])
        enter_names = {e["name"]: i for i, e in enumerate(frame.enters)}
        ordered = [None] * len(frame.enters)
        for m in frame.merges:
            for inp in m["inputs"]:
                b = inp.split(":")[0]
                if b in enter_names:
                    ordered[enter_names[b]] = m
        if any(o is None for o in ordered):
            frame.error = frame.error or (
                f"while frame {frame.name!r}: merge/enter wiring "
                "unrecognized")
            continue
        frame.merges = ordered
    return frames


# --------------------------------------------------- static trip counts
def _resolve_to_merge(name: str, by_name, frame) -> Optional[str]:
    """Follow Identity/Switch/Enter passthroughs to a Merge of `frame`;
    return the merge's name, or None."""
    merge_names = {m["name"] for m in frame.merges}
    nm = name.split(":")[0]
    for _ in range(16):
        if nm in merge_names:
            return nm
        node = by_name.get(nm)
        if node is None or node["op"] not in ("Identity", "Switch",
                                              "NextIteration"):
            return None
        nm = node["inputs"][0].split(":")[0]
    return None


def static_trip_count(frame, by_name, const_eval) -> Optional[int]:
    """Recover a trip count from the canonical counter pattern:
    ``LoopCond(Less(i, K))`` with ``i`` initialized from a const-foldable
    Enter and stepped by ``Add(i, step)`` with const step.  Returns the
    trip count, or None (the condition is then evaluated each trip)."""
    import math
    if frame.error or frame.loop_cond is None:
        return None
    cmp_nm = frame.loop_cond["inputs"][0].split(":")[0]
    cmp_node = by_name.get(cmp_nm)
    if cmp_node is None or cmp_node["op"] not in (
            "Less", "LessEqual", "Greater", "GreaterEqual"):
        return None
    lhs, rhs = cmp_node["inputs"][0], cmp_node["inputs"][1]
    merge_nm = _resolve_to_merge(lhs, by_name, frame)
    limit = const_eval(rhs.split(":")[0])
    if merge_nm is None or limit is None:
        return None
    # counter init: the merge's Enter input's outer value
    merge_ix = {m["name"]: i for i, m in enumerate(frame.merges)}
    ix = merge_ix[merge_nm]
    enter = frame.enters[ix]
    init = const_eval(enter["inputs"][0].split(":")[0])
    if init is None:
        return None
    # counter update: NextIteration input must be Add(counter, const)
    merge = frame.merges[ix]
    ni_nm = None
    for inp in merge["inputs"]:
        b = inp.split(":")[0]
        if b != enter["name"]:
            ni_nm = b
    if ni_nm is None:
        return None
    add = by_name.get(by_name[ni_nm]["inputs"][0].split(":")[0])
    if add is None or add["op"] not in ("Add", "AddV2", "Sub"):
        return None
    if add["op"] == "Sub" and _resolve_to_merge(
            add["inputs"][0].split(":")[0], by_name, frame) != merge_nm:
        # Sub(K, i) is NOT i-minus-step: modeling it as one would give a
        # wrong trip count — leave it to the evaluated condition
        return None
    step = None
    for inp in add["inputs"]:
        b = inp.split(":")[0]
        if _resolve_to_merge(b, by_name, frame) == merge_nm:
            continue
        step = const_eval(b)
    if step is None:
        return None
    # exact integer arithmetic when the counter is integral (int64
    # counters above 2^53 would round under float ceil/floor and the
    # loop would run a wrong trip count); float counters fall back to
    # ceil/floor
    integral = all(np.asarray(v).dtype.kind in "iu"
                   for v in (init, limit, step))
    if integral:
        init, limit, step = int(init), int(limit), int(step)
    else:
        init, limit, step = float(init), float(limit), float(step)
    if add["op"] == "Sub":
        step = -step
    if step == 0:
        return None
    op = cmp_node["op"]
    if op == "Less" and step > 0:
        n = (limit - init + step - 1) // step if integral \
            else math.ceil((limit - init) / step)
    elif op == "LessEqual" and step > 0:
        n = (limit - init) // step + 1 if integral \
            else math.floor((limit - init) / step) + 1
    elif op == "Greater" and step < 0:
        n = (init - limit - step - 1) // (-step) if integral \
            else math.ceil((limit - init) / step)
    elif op == "GreaterEqual" and step < 0:
        n = (init - limit) // (-step) + 1 if integral \
            else math.floor((limit - init) / step) + 1
    else:
        return None
    return max(int(n), 0)
