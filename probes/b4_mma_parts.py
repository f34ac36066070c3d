"""Where B4's mma variants (``gemm_weight_only_mma``, ``gemm_dynamic_mma``)
spend their time.

Copies ``bigdl_tpu_torch/csrc/int8_gemm.cu`` into ``build/probes/`` several
ways and builds each with the port's nvcc flags: as it is; without the
bulk copies of x's and wq's rows (the products read whatever shared
memory holds); without the products (a cheap use of the fragments
instead); without weight_only's upcast of the panel; without all three
(launch, the epilogue's loads and stores); and with the tile forced to
16x32 (four K groups) or 64x64.
Each runs through ``int8_gemm.launch`` at the quantized text cells' LSTM
projection (128, 228, 512) and ResNet-50's batch-32 stem (401408, 147,
64) in each x type and prints the device time (torch.profiler) a call,
twice in turn.  The variants other than the first compute garbage; they
only time what is left.  Run on the card from the repository root:

    python3 probes/b4_mma_parts.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from b4_mma_vs_simt import entry  # noqa: E402
from bigdl_tpu_torch.ops import _build, int8_gemm  # noqa: E402

OUT = ROOT / "build" / "probes"
NO_LOADS = [("    copy_rows(", "    if (K < 0) copy_rows(", 2),
            ("    mbar_wait(bar, phase);", "    if (K < 0) mbar_wait(bar, phase);", 2)]
NO_MMA = [("mma_16bit<F16>(acc[f], a[p], b[f]);",
           "acc[f][0] += __uint_as_float(a[p][0] ^ a[p][3] ^ b[f][1]);", 1),
          ("mma_s8(acc[f], a, b[f]);", "acc[f][0] += a[0] ^ a[3] ^ b[f][1];",
           1)]
NO_UPCAST = [("        panel_from_raw<BN, true, F16>(",
              "        if (K < 0) panel_from_raw<BN, true, F16>(", 1)]
TILE = "  return static_cast<long>((M + 63) / 64) * ((O + 63) / 64) >= sm_count();"
VARIANTS = {"as_is": [], "no_loads": NO_LOADS, "no_mma": NO_MMA,
            "no_upcast": NO_UPCAST,
            "epilogue": NO_LOADS + NO_MMA + NO_UPCAST,
            "tile16x32": [(TILE, "  return false;", 1)],
            "tile64x64": [(TILE, "  return true;", 1)]}
SHAPES = [(128, 228, 512, True), (401408, 147, 64, False)]
XDTYPES = ("float32", "bfloat16", "float16", "int8")


def source(edits) -> str:
    s = (_build.CSRC / "int8_gemm.cu").read_text()
    for a, b, n in edits:
        if s.count(a) != n:
            raise SystemExit(f"int8_gemm.cu changed: cannot edit "
                             f"{a.strip()[:60]!r}")
        s = s.replace(a, b)
    return s


def main() -> int:
    if not torch.cuda.is_available():
        print("b4_mma_parts: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, edits in VARIANTS.items():
        src = OUT / f"int8_gemm_mma_{k}.cu"
        src.write_text(source(edits))
        procs[k] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(OUT / f"libgemm_mma_{k}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {k}:\n{out}")
    fns = {k: entry(OUT / f"libgemm_mma_{k}.so") for k in VARIANTS}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(xdtype, (M, K, O), cs.operands(M, K, O, xdtype, bias, gen, dev))
             for M, K, O, bias in SHAPES for xdtype in XDTYPES]
    for _ in range(2):
        for k, fn in fns.items():
            int8_gemm._fn = fn
            row = []
            for xdtype, (M, K, O), (xin, wq, sc, b) in cases:
                ms, _ = cs.gemm_device_ms(
                    lambda: int8_gemm.launch(xin, wq, sc, b), None)
                v = int8_gemm.last_variant
                row.append(f"{xdtype[:4]} {M}x{K}x{O} ({v[1]}x{v[2]}) "
                           f"{ms:.5f}")
            print(f"{k:9s} device ms: " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
