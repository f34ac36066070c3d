"""Where the f16 PTB-medium check's readings come from, and which planted
faults stand out of them.

``chip_smoke.py``'s f16 phase trains PTB-medium in f16 for one K=8 block on
the card and redoes each step from the card's own weights
(``wd_step_reading``, norm shares against step 0's).  This probe prints,
for that block, the reading of a redo with the kernels (the card's own
floor), of a redo with the LSTM cell's plain versions on the card (the
phase's gate), of its first two steps redone on the CPU in f16, and of
four planted faults against the plain cell: layer 0's W_t x127/128, one
time step's dz x127/128 (the phase's two), and h', c' or every dz rounded
through bf16 (what a 16-bit form storing the wrong type would give).  Then
it measures, on the host's CPU, how far the CPU's f16 ``F.embedding``
backward lies from an f32 sum rounded once, at PTB-medium's batch.  Run on
the card from the repository root:

    python3 probes/f16_ptb_reading.py
"""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.ops import _build, lstm_cell  # noqa: E402


def via_bf16(t):
    return t.bfloat16().to(t.dtype)


def bf16_fault(kind):
    """The fused cell with h' and c' (``state``) or its dz (``dz``) rounded
    through bf16."""
    sound = cs.recurrent.lstm_cell

    def cell(zx, h, c, w_t, **kw):
        if kind == "dz":
            zx.register_hook(via_bf16)
            return sound(zx, h, c, w_t, **kw)
        return tuple(via_bf16(t) for t in sound(zx, h, c, w_t, **kw))
    return cell


def main() -> int:
    if not torch.cuda.is_available():
        print("f16_ptb_reading: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    for lib in _build.SOURCES:
        _build.load(lib)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K, B, T = cs.PTB["K"], cs.PTB["batch"], cs.PTB["T"]
    samples = cs.ptb_samples(0)
    batches = [cs.batch_samples(samples[i * B:(i + 1) * B])
               for i in range(K)]
    init = cs.ptb_model(cs.PTB["vocab"], cs.PTB["embed"], cs.PTB["hidden"],
                        cs.PTB["layers"]).initialize(0)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())

    def card_run(cell=None):
        sgd = cs.recording(optim.SGD)(learning_rate=1.0)
        losses = []

        class Recording(cs.LocalOptimizer):
            def _log_train_iteration(self, lr):
                losses.append(self.state["loss"])

        cs.recurrent.lstm_cell = cell or lstm_cell.lstm_cell
        try:
            (Recording(copy.deepcopy(init), cs.DataSet.array(np.zeros(K * B))
                       >> cs.Prebuilt(batches, B), crit, device=dev)
             .set_optim_method(sgd).set_gradient_clipping_by_l2_norm(5.0)
             .set_compute_dtype(torch.float16).set_steps_per_dispatch(K)
             .set_end_when(optim.max_iteration(K)).optimize())
        finally:
            cs.recurrent.lstm_cell = lstm_cell.lstm_cell
        return losses, sgd.steps

    def kernel_step(init, params, batch):
        m = copy.deepcopy(init).to(dev)
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(params[k])
                p.requires_grad_(True)
        named = dict(m.named_parameters())
        loss = cs.mixed_precision_loss_fn(m, crit, torch.float16)(
            named, torch.from_numpy(batch.input).to(dev),
            torch.from_numpy(batch.target).to(dev))
        loss.backward()
        grads = optim.clip_by_global_norm(
            {k: p.grad for k, p in named.items()}, 5.0)
        return loss.item(), {k: g.double().cpu() for k, g in grads.items()}

    def plain_step(init, params, batch):
        return cs.ptb_f16_step(init, params, batch, dev)

    def cpu_step(init, params, batch):
        return cs.ptb_f16_step(init, params, batch, torch.device("cpu"))

    def reading(run, step, n=K):
        losses, steps = run
        r, worst = cs.wd_step_reading(losses[:n], steps[:n], init, batches,
                                      step, cs.norm_share, True)
        return f"{r:.3e} {worst[:2]}"

    sound = card_run()
    print(f"f16 ptb-medium K={K}, norm shares against step 0's [{card}]")
    print(f"  redo with the kernels: {reading(sound, kernel_step)}")
    print(f"  redo with the plain cell on the card: "
          f"{reading(sound, plain_step)}")
    t0 = time.monotonic()
    print(f"  first 2 steps redone on the CPU in f16: "
          f"{reading(sound, cpu_step, 2)} ({time.monotonic() - t0:.1f} s)")
    for name, cell in (("w_t_127_128", cs.planted_lstm_fault("w_t_127_128",
                                                             T)),
                       ("one_step_dz_127_128",
                        cs.planted_lstm_fault("one_step_dz_127_128", T)),
                       ("state_bf16", bf16_fault("state")),
                       ("dz_bf16", bf16_fault("dz"))):
        print(f"  fault {name} against the plain cell: "
              f"{reading(card_run(cell), plain_step)}")

    # the CPU's f16 embedding gradient against an f32 sum rounded once
    x = batches[0].input.reshape(-1)
    ids = torch.from_numpy(x.astype(np.int64))
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(cs.PTB["vocab"], cs.PTB["embed"], generator=gen).half()
    g = torch.randn(len(ids), cs.PTB["embed"], generator=gen).half()
    w.requires_grad_(True)
    torch.nn.functional.embedding(ids, w).backward(g)
    exact = torch.zeros(w.shape).index_add_(0, ids, g.float())
    print(f"CPU f16 F.embedding backward at batch {B} x {T}: "
          f"{((w.grad.float() - exact).norm() / exact.norm()).item():.3e} "
          f"of the gradient (an f32 sum rounded once: "
          f"{((exact.half().float() - exact).norm() / exact.norm()).item():.3e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
