"""Where kernel B2f's time goes, per CTA, on the card.

Copies ``bigdl_tpu_torch/csrc/lstm_cell.cu`` into ``build/probes/`` with
timestamps added at the forward kernel's phase boundaries (thread 0 of
every CTA writes ``clock64`` at: start, the first chunk landed, the K loop
done, the cluster's start barrier passed, the partials landed, the end;
``%globaltimer`` at start and end), builds it four ways with the port's
nvcc flags (as it is; without the W_t/h copies; without the FMAs;
without both), runs each at PTB-medium's (N=20, H=650) f32 with W_t warm
in L2 and prints its device time (torch.profiler) and the median and
largest cycles of each phase over the CTAs.  The variants without copies
or FMAs compute garbage; they only time what is left.  Run on the card
from the repository root:

    python3 probes/b2f_phases.py
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch.ops import _build  # noqa: E402

OUT = ROOT / "build" / "probes"
VARIANTS = {"as_is": [], "no_copies": ["-DNOLOAD"], "no_fma": ["-DNOCOMPUTE"],
            "neither": ["-DNOLOAD", "-DNOCOMPUTE"]}
PHASES = [(1, 2, "first chunk landed"), (2, 3, "K loop"),
          (3, 4, "start barrier"), (4, 5, "push + cluster barrier"),
          (5, 6, "finish")]
MAX_CTAS = 8192


def instrumented_source() -> str:
    s = (_build.CSRC / "lstm_cell.cu").read_text()

    def rep(a, b):
        nonlocal s
        if s.count(a) != 1:
            raise SystemExit(f"lstm_cell.cu changed: cannot place a mark at "
                             f"{a.strip()[:60]!r}")
        s = s.replace(a, b)

    rep("namespace cg = cooperative_groups;", f"""namespace cg = cooperative_groups;
__device__ unsigned long long g_t[{MAX_CTAS}][8];
extern "C" int get_times(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, g_t, sizeof(g_t));
}}
#define MARK(i) do {{ if (threadIdx.x == 0) \\
  g_t[blockIdx.x + gridDim.x * blockIdx.y][i] = clock64(); }} while (0)
#define GMARK(i) do {{ if (threadIdx.x == 0) {{ unsigned long long t; \\
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); \\
  g_t[blockIdx.x + gridDim.x * blockIdx.y][i] = t; }} }} while (0)""")
    rep("  cg::cluster_group cluster = cg::this_cluster();\n",
        "  GMARK(0); MARK(1);\n  cg::cluster_group cluster = cg::this_cluster();\n")
    rep("    __syncthreads();  // chunk ch landed; everyone is done with chunk "
        "ch-1's stage\n",
        "    __syncthreads();  // chunk ch landed; everyone is done with chunk "
        "ch-1's stage\n    if (ch == 0) MARK(2);\n")
    rep('  asm volatile("barrier.cluster.wait;\\n" ::: "memory");',
        '  MARK(3);\n  asm volatile("barrier.cluster.wait;\\n" ::: "memory");'
        '\n  MARK(4);')
    rep("  cluster.sync();  // every partial has landed",
        "  cluster.sync();  // every partial has landed\n  MARK(5);")
    rep("    const int st = ch % STAGES;\n",
        "    const int st = ch % STAGES;\n#ifdef NOCOMPUTE\n    continue;\n"
        "#endif\n")
    for call in ("    if (st < chunks) load(st, st);",
                 "    if (ch + STAGES - 1 < chunks) load(ch + STAGES - 1, "
                 "(ch + STAGES - 1) % STAGES);"):
        rep(call, f"#ifndef NOLOAD\n{call}\n#endif")
    i = s.index("  if (finisher) {", s.index("every partial has landed"))
    j = s.index("\n}\n", i)
    return s[:j] + "\n  MARK(6); GMARK(7);" + s[j:]


def main() -> int:
    if not torch.cuda.is_available():
        print("b2f_phases: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "lstm_phases.cu"
    src.write_text(instrumented_source())
    nvcc = _build._nvcc()
    procs = {k: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(OUT / f"lib{k}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k, flags in VARIANTS.items()}
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {k}:\n{out}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    N, H = cs.PTB["batch"], cs.PTB["hidden"]
    zx, h, c, w_t, _, _ = cs.cell_operands(N, H, torch.float32, gen, dev)
    h_new, c_new = torch.empty_like(h), torch.empty_like(c)
    z = torch.empty(N, 4 * H, device=dev)
    info = (ctypes.c_int * 4)()
    stream = torch.cuda.current_stream().cuda_stream
    for k in VARIANTS:
        lib = ctypes.CDLL(str(OUT / f"lib{k}.so"))
        fn = lib.bigdl_lstm_cell_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])

        def call():
            err = fn(0, zx.data_ptr(), h.data_ptr(), c.data_ptr(),
                     w_t.data_ptr(), h_new.data_ptr(), c_new.data_ptr(),
                     z.data_ptr(), N, H, 0.0, stream, info)
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")

        ms = cs.device_ms(call)
        call()  # the timestamps of one warm launch
        torch.cuda.synchronize()
        t = np.zeros((MAX_CTAS, 8), np.uint64)
        if lib.get_times(ctypes.c_void_p(t.ctypes.data)):
            raise RuntimeError("cannot read the timestamps")
        ctas = info[0]
        t = t[:ctas].astype(np.int64)
        span = t[:, 7].max() - t[:, 0].min()
        print(f"{k}: device_ms={ms:.5f} ({ctas} CTAs, clusters of {info[1]}, "
              f"{info[2]}-byte copies); first start to last end {span} ns")
        for a, b, name in PHASES:
            d = t[:, b] - t[:, a]
            print(f"  {name:24s} cycles median {np.median(d):8.0f} "
                  f"max {d.max():8d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
