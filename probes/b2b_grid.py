"""B2b (the LSTM cell's elementwise backward) at other launch shapes.

Copies ``bigdl_tpu_torch/csrc/lstm_cell.cu`` into ``build/probes/`` with the
backward's block size set to 32, 64, 128 and 256 threads, plus the source's
shape with ``expf`` and ``tanhf`` taken as the identity (what is left is the
memory round trip);
builds each with the port's nvcc flags, and runs each through
``lstm_cell.launch_bwd`` at PTB-medium's (N=20, H=650) f32 (the inputs of
``chip_smoke.py``'s LSTM kernel phase): agreement with the plain version
within ``CELL_TOL`` (not for the identity variant), the grid, and the
device time (torch.profiler) a call beside an empty kernel of the same
grid, twice in turn.  Run on the card
from the repository root:

    python3 probes/b2b_grid.py
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
from bigdl_tpu_torch.ops import _build, lstm_cell  # noqa: E402

OUT = ROOT / "build" / "probes"
THREADS = "constexpr int BWD_THREADS = 128;"
INCLUDES = "#include <stdint.h>\n"
IDENTITY = "#define expf(x) (x)\n#define tanhf(x) (x)\n"
SHAPES = [(t, "accurate") for t in (32, 64, 128, 256)] + [(128, "identity")]


def main() -> int:
    if not torch.cuda.is_available():
        print("b2b_grid: no CUDA card", file=sys.stderr)
        return 2
    print(f"card: {cs.card_line()}")
    OUT.mkdir(parents=True, exist_ok=True)
    s = (_build.CSRC / "lstm_cell.cu").read_text()
    if s.count(THREADS) != 1 or s.count(INCLUDES) != 1:
        raise SystemExit("lstm_cell.cu changed: cannot set the launch shape")
    nvcc = _build._nvcc()
    procs = {}
    for t, math in SHAPES:
        src = OUT / f"lstm_cell_{t}_{math}.cu"
        text = s.replace(THREADS, f"constexpr int BWD_THREADS = {t};")
        if math == "identity":
            text = text.replace(INCLUDES, INCLUDES + IDENTITY)
        src.write_text(text)
        procs[t, math] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o",
             str(OUT / f"liblstm_cell_{t}_{math}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for k, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed for {k}:\n{out}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    N, H = cs.PTB["batch"], cs.PTB["hidden"]
    zx, h, c, w_t, dh, dc = cs.cell_operands(N, H, torch.float32, gen, dev)
    z = lstm_cell.lstm_cell_fwd_reference(zx, h, c, w_t, 0.0)[2]
    want = lstm_cell.lstm_cell_bwd_reference(z, c, dh, dc, 0.0)
    tol = cs.cell_tol("lstm_cell_bwd", H, torch.float32)
    for _ in range(2):
        for t, math in SHAPES:
            _build._libs["lstm_cell"] = ctypes.CDLL(
                str(OUT / f"liblstm_cell_{t}_{math}.so"))
            lstm_cell._fns.clear()
            got = lstm_cell.launch_bwd(z, c, dh, dc, 0.0)
            torch.cuda.synchronize()
            for g, w in zip(got, want if math == "accurate" else ()):
                torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            shape = lstm_cell.last_bwd_shape
            k_ms = cs.device_ms(lambda: lstm_cell.launch_bwd(z, c, dh, dc))
            f_ms = cs.device_ms(
                lambda: lstm_cell.launch_bwd_empty(z, c, dh, dc))
            print(f"b2b {t} threads, {math}: {shape[0]} blocks "
                  f"of {shape[1]}; kernel_ms="
                  f"{k_ms:.5f} floor_ms={f_ms:.5f} kernel/floor "
                  f"{k_ms / f_ms:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
