"""B1's ``tiled_nchw`` variant against the ``two_pass`` it replaced, in one
process.

Builds the max-pool backward of another checkout (``--against``, the source
file of a tree whose NCHW pools still went to ``two_pass``) with the port's
nvcc flags beside this tree's, and a copy of this tree's with the register
form turned off (so that 2x2/2 pools take the tile form), and, with
``--tile-against``, another source file's ``tiled_nchw`` (timed at the
cases that take the tile form).
Then, at every NCHW pool of a main path (VGG for CIFAR-10's five at batch
128, LeNet-5's two at batch 128 in f32 and f16, the Inception check's
pool1, 3a and 5a at batch 4), each build is checked bitwise against the
plain version on integer inputs (ties) and on post-ReLU inputs, and timed
on the post-ReLU ones: device ms a call (torch.profiler, 20 calls), in
turns (other, this[, tile form or tile-against, twice each], this, other),
beside the bound
(``chip_smoke.pool_bound``: x, y, g read once, gi written once) and the
library's ``aten.max_pool2d_with_indices_backward`` (handed the forward's
indices).  Run on the card from the repository root, with the parent
unpacked into a listed directory:

    git archive HEAD~1 | (mkdir -p build/parent && tar -x -C build/parent)
    python3 probes/b1_nchw_vs_two_pass.py --against build/parent/bigdl_tpu_torch/csrc/maxpool_bwd.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch.ops import _build, maxpool  # noqa: E402

OUT = ROOT / "build" / "probes"
CASES = (*cs.VGG_POOL_CASES, "lenet_pool1_nchw_f32", "lenet_pool2_nchw_f32",
         "lenet_pool1_nchw_f16", "lenet_pool2_nchw_f16",
         "inception_check_pool1_nchw_f32", "inception_check_3a_nchw_f32",
         "inception_check_5a_nchw_f32")
# the register form's gate in plan_planes; false in the tile-form copy
REGISTER_GATE = "if (q.kh == 2 && q.kw == 2 && q.sh == 2 && q.sw == 2"


def entry(path: Path):
    lib = ctypes.CDLL(str(path))
    pick, fn = lib.bigdl_maxpool_bwd_variant, lib.bigdl_maxpool_bwd
    geometry = [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_int]
    pick.restype = fn.restype = ctypes.c_int
    pick.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + geometry
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + geometry
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    return pick, fn


def build(sources):
    """{name: library} of {name: source}, one nvcc each, all together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = OUT / f"libmaxpool_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="maxpool_bwd.cu of the tree to compare with")
    ap.add_argument("--tile-against",
                    help="another maxpool_bwd.cu whose tiled_nchw to time "
                         "beside this tree's where the tile form runs")
    ap.add_argument("--json-out", help="write the rows here as JSON too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_nchw_vs_two_pass: no CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}")
    text = (_build.CSRC / "maxpool_bwd.cu").read_text()
    if text.count(REGISTER_GATE) != 1:
        raise SystemExit("maxpool_bwd.cu changed: cannot turn the register "
                         "form off")
    OUT.mkdir(parents=True, exist_ok=True)
    tile_src = OUT / "maxpool_tile_form.cu"
    tile_src.write_text(text.replace(REGISTER_GATE,
                                     REGISTER_GATE.replace("(", "(false && ",
                                                           1)))
    sources = {"other": args.against, "tile_form": tile_src}
    if args.tile_against:
        sources["tile_against"] = args.tile_against
    libs = build(sources)
    fns = {"two_pass": entry(libs["other"]),
           "tiled_nchw": maxpool._kernel_fns(),
           "tile_form": entry(libs["tile_form"])}
    if args.tile_against:
        fns["tile_against"] = entry(libs["tile_against"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2323)
    rows = []
    for name in CASES:
        case = cs.pool_case(name)
        shape, k, s, p, ceil, fmt, dtype = case[1:8]
        ops = {kind: cs.pool_operands(shape, k, s, p, ceil, fmt, dtype, kind,
                                      gen, dev) for kind in ("ints", "relu")}
        x, y, g, pads, kk, ss = ops["relu"]
        maxpool._fns = fns["tiled_nchw"]
        maxpool.launch(x, y, g, kk, ss, pads)
        registers = maxpool.last_variant[4] > 0
        other_tile = ("tile_form" if registers else
                      "tile_against" if args.tile_against else None)
        order = (["two_pass", "tiled_nchw"]
                 + ([other_tile] * 2 if other_tile else [])
                 + ["tiled_nchw", "two_pass"])
        ms = {key: [] for key in order}
        variants = {}
        for key in order:
            maxpool._fns = fns[key]
            for kind, (xo, yo, go, po, ko, so) in ops.items():
                got = maxpool.launch(xo, yo, go, ko, so, po)
                want = maxpool.maxpool_bwd_reference(xo, yo, go, ko, so, po)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{key} at {name} ({kind}): not "
                                         f"bitwise equal to the plain version")
            variants[key] = list(maxpool.last_variant)
            want_name = "two_pass" if key == "two_pass" else "tiled_nchw"
            if variants[key][0] != want_name:
                raise AssertionError(f"{key} at {name} took {variants[key]}")
            ms[key].append(cs.device_ms(
                lambda: maxpool.launch(x, y, g, kk, ss, pads), calls=20))
        maxpool._fns = fns["tiled_nchw"]
        kl, sl, pl = list(kk), list(ss), list(cs.pair(p))
        _, ind = torch.nn.functional.max_pool2d(x, kl, sl, pl, ceil_mode=ceil,
                                                return_indices=True)
        lib_ms = cs.device_ms(
            lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                g, x, kl, sl, pl, [1, 1], ceil, ind), calls=20)
        b_ms, b_by, nbytes = cs.pool_bound(shape, y.shape, dtype)
        row = {"case": name, "x": list(x.shape), "dtype": str(dtype),
               "kernel": list(kk), "stride": list(ss), "pads": pads,
               "ms": ms, "variants": variants, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "card": card}
        rows.append(row)
        form = (f"registers, {variants['tiled_nchw'][4]} windows a thread"
                if registers else
                f"tile of {variants['tiled_nchw'][1]}, "
                f"{variants['tiled_nchw'][2]} planes a block")
        parts = [f"tiled_nchw ({form}, {variants['tiled_nchw'][3]} blocks) "
                 + " ".join(f"{t:.5f}" for t in ms["tiled_nchw"]) + " ms"]
        if registers:
            parts.append(f"its tile form (tile of {variants['tile_form'][1]}, "
                         f"{variants['tile_form'][2]} planes) "
                         + " ".join(f"{t:.5f}" for t in ms["tile_form"])
                         + " ms")
        if other_tile == "tile_against":
            parts.append(f"--tile-against's (tile of "
                         f"{variants['tile_against'][1]}, "
                         f"{variants['tile_against'][2]} planes) "
                         + " ".join(f"{t:.5f}" for t in ms["tile_against"])
                         + " ms")
        parts.append("two_pass " + " ".join(f"{t:.5f}" for t in ms["two_pass"])
                     + " ms")
        print(f"{name} x {tuple(x.shape)} {dtype} kernel {kk} stride {ss}: "
              + ", ".join(parts) + f"; bound {b_ms:.5f} ms ({b_by}: "
              f"{nbytes / 1e6:.2f} MB); library {lib_ms:.5f} ms; all bitwise "
              f"[{card}]", flush=True)
        del ops, x, y, g, ind
        torch.cuda.empty_cache()
    maxpool._fns = None
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
