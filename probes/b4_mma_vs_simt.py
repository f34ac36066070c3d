"""B4's mma variants against the SIMT kernels they replaced, in one process.

Builds the int8 GEMM of another checkout (``--against``, the source file of
a tree whose K % 16 != 0 shapes still went to ``gemm_weight_only`` and
``gemm_dynamic``, the SIMT kernels) with the port's nvcc flags beside this
tree's, then at every shape the mma variants take on a main path (the
quantized text cells' projections, M 128, K 228; ResNet-50's batch-32 stem,
M 401408, K 147, O 64) and every x type checks both against the plain
version (dynamic bitwise, weight_only ``rtol=1e-5, atol=1e-5*max|y|``)
and prints each one's device time a call (torch.profiler), in turns:
other, this, this, other, beside the bound (``chip_smoke.bound``) and the
library calls' device time (the dequantized ``addmm`` in x's type, f32
for int8 rows, and ``_int_mm`` for int8 rows).  Run on the card from the
repository root, with the parent unpacked into a listed directory:

    git archive HEAD~1 | (mkdir -p build/parent && tar -x -C build/parent)
    python3 probes/b4_mma_vs_simt.py --against build/parent/bigdl_tpu_torch/csrc/int8_gemm.cu
"""

from __future__ import annotations

import argparse
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
# (M, K, O, bias): the cells' gates (LSTM), gates and candidate (GRU); the
# stem
SHAPES = [(128, 228, 512, True), (128, 228, 256, True),
          (128, 228, 128, True), (401408, 147, 64, False)]
XDTYPES = ("float32", "bfloat16", "float16", "int8")


def entry(path: Path):
    fn = ctypes.CDLL(str(path)).bigdl_int8_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="int8_gemm.cu of the tree to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b4_mma_vs_simt: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    OUT.mkdir(parents=True, exist_ok=True)
    other_lib = OUT / "libgemm_other.so"
    build = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(other_lib),
         args.against], capture_output=True, text=True)
    if build.returncode:
        raise SystemExit(f"nvcc failed for {args.against}:\n{build.stdout}"
                         f"{build.stderr}")
    fns = {"this": int8_gemm._kernel_fn(), "other": entry(other_lib)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    for M, K, O, bias in SHAPES:
        for xdtype in XDTYPES:
            xin, wq, sc, b = cs.operands(M, K, O, xdtype, bias, gen, dev)
            want = cs.int8_matmul_reference(xin, wq, sc, b)
            ms = {k: [] for k in fns}
            variant = {}
            for k in ("other", "this", "this", "other"):
                int8_gemm._fn = fns[k]
                got = int8_gemm.launch(xin, wq, sc, b)
                torch.cuda.synchronize()
                variant[k] = int8_gemm.last_variant
                if xdtype == "int8":
                    if not torch.equal(got, want):
                        raise AssertionError(f"{k} not bitwise at {M}x{K}x{O}")
                else:
                    torch.testing.assert_close(
                        got, want, rtol=1e-5,
                        atol=1e-5 * want.abs().max().item())
                del got
                ms[k].append(cs.gemm_device_ms(
                    lambda: int8_gemm.launch(xin, wq, sc, b), None)[0])
            # the yardsticks: the dequantized addmm in x's type (f32 for
            # int8 rows) and, for int8 rows, _int_mm too
            libs = {"addmm": cs.library_call(xin, wq, sc, b, xdtype, True)}
            if xdtype == "int8":
                libs["_int_mm"] = cs.int_mm_call(xin, wq)
            lib_ms = {k: cs.gemm_device_ms(
                lambda: int8_gemm.launch(xin, wq, sc, b), f)[1]
                for k, f in libs.items() if f is not None}
            b_ms, b_by, _ = cs.bound(M, K, O, bias, xdtype)
            v = variant["this"]
            print(f"{M}x{K}x{O} bias={int(bias)} x {xdtype}: this ({v[1]}x"
                  f"{v[2]}, {v[3]} K chunk(s), {v[4]} blocks) "
                  f"{ms['this'][0]:.5f} {ms['this'][1]:.5f} ms, other "
                  f"({variant['other'][1]}x{variant['other'][2]}, "
                  f"{variant['other'][4]} blocks) {ms['other'][0]:.5f} "
                  f"{ms['other'][1]:.5f} ms; bound {b_ms:.6f} ms ({b_by}); "
                  + ", ".join(f"{k} {t:.5f}" for k, t in lib_ms.items())
                  + f" ms [{cs.card_line()}]", flush=True)
            del xin, wq, sc, b, want
            torch.cuda.empty_cache()
    int8_gemm._fn = fns["this"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
