"""Where B1's ``tiled_nchw`` tile form spends its time.

Copies ``bigdl_tpu_torch/csrc/maxpool_bwd.cu`` into ``build/probes/`` with
the register form turned off (2x2/2 pools then take the tile form too) and
with parts of the tile-form kernel cut out: ``as_is``; ``no_gather`` (the
block returns after its windows' first matches, before writing gi);
``no_x`` (no x is read and no window scanned: every first match is offset
0); ``no_stores`` (computes every gi element but stores almost none).
Builds each with the port's nvcc flags and times each (device ms a call,
torch.profiler, 20 calls) at VGG's pool 1, LeNet's pool 1 and the Inception
check's pool1, 3a and 5a on post-ReLU inputs; only ``as_is`` is checked
(bitwise against the plain version).  Run on the card from the repository
root:

    python3 probes/b1_nchw_parts.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "probes"))

import chip_smoke as cs  # noqa: E402
from b1_nchw_vs_two_pass import REGISTER_GATE, build, entry  # noqa: E402
from bigdl_tpu_torch.ops import _build, maxpool  # noqa: E402

OUT = ROOT / "build" / "probes"
CASES = ("vgg_pool1_nchw_f32", "lenet_pool1_nchw_f32",
         "inception_check_pool1_nchw_f32", "inception_check_3a_nchw_f32",
         "inception_check_5a_nchw_f32")
GATHER = "  // (2) each gi element of the tile once"
HIT = "    hits[i] = WindowHit{gv, found};"
STORE = ("store(gi + plane_offset(p0 + pl, q, q.gis) + (hp - q.ph) * "
         "q.gis[2] + wp - q.pw, acc);")
PARTS = {"as_is": [],
         "no_gather": [(GATHER, "  if (q.pb > 0) return;\n" + GATHER)],
         "no_x": [(HIT, "    hits[i] = WindowHit{gv, 0};")],
         "no_stores": [(STORE, "if (acc == 1234.5f) " + STORE)]}


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_nchw_parts: no CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}")
    text = (_build.CSRC / "maxpool_bwd.cu").read_text()
    base = text.replace(REGISTER_GATE,
                        REGISTER_GATE.replace("(", "(false && ", 1))
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}
    if text.count(REGISTER_GATE) != 1:
        raise SystemExit("maxpool_bwd.cu changed: cannot turn the register "
                         "form off")
    for part, edits in PARTS.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"maxpool_bwd.cu changed: cannot make "
                                 f"{part} ({old!r})")
            src = src.replace(old, new)
        path = OUT / f"maxpool_part_{part}.cu"
        path.write_text(src)
        sources[part] = path
    fns = {part: entry(lib) for part, lib in build(sources).items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2323)
    for name in CASES:
        shape, k, s, p, ceil, fmt, dtype = cs.pool_case(name)[1:8]
        x, y, g, pads, kk, ss = cs.pool_operands(shape, k, s, p, ceil, fmt,
                                                 dtype, "relu", gen, dev)
        row = []
        for _ in range(2):
            for part in PARTS:
                maxpool._fns = fns[part]
                got = maxpool.launch(x, y, g, kk, ss, pads)
                torch.cuda.synchronize()
                if part == "as_is" and not torch.equal(
                        got, maxpool.maxpool_bwd_reference(x, y, g, kk, ss,
                                                           pads)):
                    raise AssertionError(f"as_is at {name}: not bitwise")
                ms = cs.device_ms(
                    lambda: maxpool.launch(x, y, g, kk, ss, pads), calls=20)
                row.append(f"{part} {ms:.5f}")
        v = maxpool.last_variant
        print(f"{name} x {tuple(x.shape)} kernel {kk} stride {ss} (tile of "
              f"{v[1]}, {v[2]} planes, {v[3]} blocks) device ms: "
              + ", ".join(row) + f" [{card}]", flush=True)
        del x, y, g
    maxpool._fns = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
