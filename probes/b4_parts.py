"""What holds B4's weight_only kernel (``gemm_weight_only_wgmma``) back.

Copies ``bigdl_tpu_torch/csrc/int8_gemm.cu`` into ``build/probes/`` five
ways and builds each with the port's nvcc flags: as it is; without the
three-way split of f32 x (each fragment register gets x's truncated high
half instead); without the int8-to-bf16 upcast of the weight tile; without
either; and with one pass instead of three (no split).  Each runs through
``int8_gemm.launch`` at five ResNet-50 batch-32 shapes with f32 x and two
with bf16 x, and prints the device time (torch.profiler) a call, twice in
turn.  The variants other than the first compute garbage; they only time
what is left.  Run on the card from the repository root:

    python3 probes/b4_parts.py
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
from bigdl_tpu_torch.ops import _build, int8_gemm  # noqa: E402

OUT = ROOT / "build" / "probes"
SPLIT = "split3(v, f[j], f[4 + j], f[8 + j]);"
NO_SPLIT = "f[j] = f[4 + j] = f[8 + j] = __float_as_uint(v.x) & 0xffff0000u;"
UPCAST = """      const uint2 lo = bf16x4_of_s8(v.x), hi = bf16x4_of_s8(v.y);
      *reinterpret_cast<uint4*>(wbf + sw128_offset(r, 8 * c, 2)) =
          make_uint4(lo.x, lo.y, hi.x, hi.y);"""
# keeps the loads, drops the conversion and the stores
NO_UPCAST = "      if (v.x == 0x7fffffffu) *reinterpret_cast<uint2*>(wbf) = v;"
PASSES = "constexpr int PASSES = F32 ? 3 : 1;"
ONE_PASS = [(PASSES, "constexpr int PASSES = 1;"),
            (SPLIT, "f[j] = __float_as_uint(v.x) & 0xffff0000u;")]
VARIANTS = {"as_is": [], "no_split": [(SPLIT, NO_SPLIT)],
            "no_upcast": [(UPCAST, NO_UPCAST)],
            "neither": [(SPLIT, NO_SPLIT), (UPCAST, NO_UPCAST)],
            "one_pass": ONE_PASS}
SHAPES = [(6272, 2304, 256), (1568, 4608, 512), (25088, 1152, 128),
          (25088, 128, 512), (100352, 64, 256)]
BF16_SHAPES = SHAPES[:2]


def source(edits) -> str:
    s = (_build.CSRC / "int8_gemm.cu").read_text()
    for a, b in edits:
        if s.count(a) != 1:
            raise SystemExit(f"int8_gemm.cu changed: cannot edit "
                             f"{a.strip()[:60]!r}")
        s = s.replace(a, b)
    return s


def main() -> int:
    if not torch.cuda.is_available():
        print("b4_parts: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for k, edits in VARIANTS.items():
        src = OUT / f"int8_gemm_{k}.cu"
        src.write_text(source(edits))
        procs[k] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"libgemm_{k}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {k}:\n{out}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = ([("float32", s, cs.operands(*s, "float32", False, gen, dev))
              for s in SHAPES]
             + [("bfloat16", s, cs.operands(*s, "bfloat16", False, gen, dev))
                for s in BF16_SHAPES])
    for _ in range(2):
        for k in VARIANTS:
            fn = ctypes.CDLL(str(OUT / f"libgemm_{k}.so")).bigdl_int8_gemm
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
            int8_gemm._fn = fn
            row = []
            for xdtype, (M, K, O), (xin, wq, sc, b) in cases:
                ms, _ = cs.gemm_device_ms(
                    lambda: int8_gemm.launch(xin, wq, sc, b), None)
                v = int8_gemm.last_variant
                row.append(f"{xdtype[:4]} {M}x{K}x{O} ({v[1]}x{v[2]}) "
                           f"{ms:.4f}")
            print(f"{k:9s} device ms: " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
