"""Per-block phase clocks of B4's mma variants.

Copies ``bigdl_tpu_torch/csrc/int8_gemm.cu`` into ``build/probes/`` with
``clock64`` and ``%globaltimer`` marks in ``gemm_weight_only_mma`` and
``gemm_dynamic_mma`` (block start; the bulk copies issued; the copies
landed; the panel and the products done; tile stored), builds it with the
port's nvcc flags, and runs it through ``int8_gemm.launch`` three times at the quantized text cells' LSTM
projection (128, 228, 512) in f32 and int8 x and at ResNet-50's batch-32
stem (401408, 147, 64) in f32, f16 and int8 x.  The first and the last
block of each launch print their cycles per phase and their start and end
on the global timer (ns), beside the kernel's device time
(torch.profiler).  Run on the card from the repository root:

    python3 probes/b4_mma_clock.py
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
START = "  float sc[NF][2], bi[NF][2];\n"
MARK0 = ("  unsigned long long G0, G1;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(G0));\n"
         "  long long T0 = clock64(), T1 = 0, T2 = 0, T3 = 0;\n")
COPY = ("      copy_rows(rx, {p1}, xr, rw, {p2}, wr, whole, bar);\n"
        "      mbar_wait(bar, phase);\n")
MARKS = ("      T1 = clock64();\n      copy_rows(rx, {p1}, xr, rw, {p2}, wr, whole, bar);\n"
         "      T2 = clock64();\n      mbar_wait(bar, phase);\n      T3 = clock64();\n")
STORE = ("    if (group == 0)\n"
         "      store_mma_tile<NF, HAS_BIAS>({acc}, sc, bi, y, M, O, m0 + ra - lane / 4, "
         "n0 + na, vec);\n")
# the first and the second M tile of the first and the last block
PRINT = ("    const long long T4 = clock64();\n" + "{store}" +
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(G1));\n"
         "    if (threadIdx.x == 0 && mt - mt0 < 2 * (gridDim.x / tiles_o) &&\n"
         "        (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1))\n"
         "      printf(\"{name} block %d of %d tile %d: setup %lld copy-issue %lld wait %lld "
         "panel+products %lld store %lld cycles; start %llu end %llu ns\\n\", "
         "blockIdx.x, gridDim.x, mt, T1 - T0, T2 - T1, T3 - T2, T4 - T3, "
         "clock64() - T4, G0, G1);\n"
         "    T0 = clock64();\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(G0));\n")
SHAPES = [(128, 228, 512, True, "float32"), (128, 228, 512, True, "int8"),
          (401408, 147, 64, False, "float32"),
          (401408, 147, 64, False, "float16"),
          (401408, 147, 64, False, "int8")]


def source() -> str:
    s = (_build.CSRC / "int8_gemm.cu").read_text()
    edits = [(START, MARK0 + START, 2),
             (COPY.format(p1="px", p2="pw"), MARKS.format(p1="px", p2="pw"), 1),
             (COPY.format(p1="pr", p2="pr"), MARKS.format(p1="pr", p2="pr"), 1),
             (STORE.format(acc="sum"), PRINT.format(
                 store=STORE.format(acc="sum"), name="weight_only"), 1),
             (STORE.format(acc="acc"), PRINT.format(
                 store=STORE.format(acc="acc"), name="dynamic"), 1)]
    for a, b, n in edits:
        if s.count(a) != n:
            raise SystemExit(f"int8_gemm.cu changed: cannot edit "
                             f"{a.strip()[:60]!r}")
        s = s.replace(a, b)
    return "#include <cstdio>\n" + s


def main() -> int:
    if not torch.cuda.is_available():
        print("b4_mma_clock: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "int8_gemm_clock.cu"
    src.write_text(source())
    lib = OUT / "libgemm_clock.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed:\n{out.stdout}{out.stderr}")
    timed = int8_gemm._kernel_fn()
    clocked = entry(lib)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    for M, K, O, bias, xdtype in SHAPES:
        xin, wq, sc, b = cs.operands(M, K, O, xdtype, bias, gen, dev)
        int8_gemm._fn = timed
        ms, _ = cs.gemm_device_ms(
            lambda: int8_gemm.launch(xin, wq, sc, b), None)
        v = int8_gemm.last_variant
        print(f"{M}x{K}x{O} x {xdtype}: {v[0]} {v[1]}x{v[2]}, {v[4]} blocks, "
              f"device ms {ms:.5f}", flush=True)
        int8_gemm._fn = clocked
        for _ in range(3):
            int8_gemm.launch(xin, wq, sc, b)
            torch.cuda.synchronize()
            sys.stdout.flush()
        del xin, wq, sc, b
    int8_gemm._fn = timed
    return 0


if __name__ == "__main__":
    sys.exit(main())
