"""B1's ``tiled_nhwc`` variant at other tile shapes.

Copies ``bigdl_tpu_torch/csrc/maxpool_bwd.cu`` into ``build/probes/`` with
the gi tile (rows x columns) set to 8x8, 16x8, 8x16 and 16x16, builds each
with the port's nvcc flags, and runs each through ``maxpool.launch`` at the
ResNet-50 stem at batch 256 (x 256x112x112x64 NHWC, 3x3/2 pad 1,
post-ReLU, the same inputs as ``chip_smoke.py``'s timed phase) in bf16 and
f32: the variant it took, bitwise equality with the plain version, and the
device time (torch.profiler) a call, twice in turn.  A tile whose shared
memory does not fit takes two_pass.  Run on the card from the repository
root:

    python3 probes/b1_tiles.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch.ops import _build, maxpool  # noqa: E402

OUT = ROOT / "build" / "probes"
TILE = "constexpr int TILE_H = 8, TILE_W = 16;"
TILES = [(8, 8), (16, 8), (8, 16), (16, 16)]


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_tiles: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    OUT.mkdir(parents=True, exist_ok=True)
    s = (_build.CSRC / "maxpool_bwd.cu").read_text()
    if s.count(TILE) != 1:
        raise SystemExit("maxpool_bwd.cu changed: cannot set the tile")
    nvcc = _build._nvcc()
    procs = {}
    for th, tw in TILES:
        src = OUT / f"maxpool_{th}x{tw}.cu"
        src.write_text(s.replace(
            TILE, f"constexpr int TILE_H = {th}, TILE_W = {tw};"))
        procs[th, tw] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o",
             str(OUT / f"libmaxpool_{th}x{tw}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {k}:\n{out}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2718)
    cases = {}
    for name, dtype in (("stem_nhwc_bf16", torch.bfloat16),
                        ("stem_nhwc_f32", torch.float32)):
        case = next(c for c in cs.POOL_CASES if c[0] == name)
        cases[name] = cs.pool_operands(*case[1:7], dtype, "relu", gen, dev)
    geometry = [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_int]
    for _ in range(2):
        for th, tw in TILES:
            lib = ctypes.CDLL(str(OUT / f"libmaxpool_{th}x{tw}.so"))
            pick, fn = lib.bigdl_maxpool_bwd_variant, lib.bigdl_maxpool_bwd
            pick.restype = fn.restype = ctypes.c_int
            pick.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + geometry
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + geometry
                           + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
            maxpool._fns = (pick, fn)
            row = []
            for name, (x, y, g, pads, k, st) in cases.items():
                got = maxpool.launch(x, y, g, k, st, pads)
                same = torch.equal(
                    got, maxpool.maxpool_bwd_reference(x, y, g, k, st, pads))
                ms = cs.device_ms(
                    lambda: maxpool.launch(x, y, g, k, st, pads), calls=20)
                row.append(f"{name} {maxpool.last_variant[0]} "
                           f"bitwise={same} {ms:.4f}")
            print(f"{th}x{tw} device ms: " + " | ".join(row), flush=True)
    maxpool._fns = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
