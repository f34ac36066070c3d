"""Child process of ``tests/test_torch_checkpoint.py``: trains a small MLP
on synthetic MNIST through the port's ``LocalOptimizer`` on the CPU, with
snapshots every ``--every`` iterations, and appends one ``<step>
<repr(loss)>`` line an iteration to ``--losses`` (flushed at once, so the
parent can watch it and kill the process mid-epoch).  ``--resume``
restores the latest valid snapshot first; ``--params-out`` writes the
final parameters; ``--preemption`` installs the SIGTERM handler.

Exit codes: 0 ok (a clean preemption included), 3 when ``--resume`` finds
no valid snapshot.  Imports neither JAX nor the reference package.
"""

import argparse
import sys

import numpy as np
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.dataset import DataSet, SampleToMiniBatch
from bigdl_tpu_torch.dataset import image, mnist

N_SAMPLES, BATCH = 320, 32  # 10-step epochs: kills land mid-epoch


def pipeline():
    imgs, labels = mnist.synthetic_mnist(N_SAMPLES, seed=0)
    return (DataSet.array(mnist.to_samples(imgs, labels))
            >> image.BytesToGreyImg()
            >> image.GreyImgNormalizer(mnist.TRAIN_MEAN, mnist.TRAIN_STD)
            >> SampleToMiniBatch(BATCH))


def mlp():
    return (nn.Sequential()
            .add(nn.Reshape((784,)))
            .add(nn.Linear(784, 32)).add(nn.Tanh())
            .add(nn.Linear(32, 10)).add(nn.LogSoftMax())).initialize(0)


class LossLog:
    """TrainSummary stand-in writing one line an iteration."""

    def __init__(self, path, every_step=None):
        self._fh = open(path, "a", buffering=1)
        self.every_step = every_step  # (step, callable) or None

    def add_train_step(self, step, loss, lr, throughput):
        self._fh.write(f"{step} {loss!r}\n")
        self._fh.flush()
        if self.every_step is not None and step == self.every_step[0]:
            self.every_step[1]()

    def trigger_for(self, name):
        return None


def build_optimizer(ckpt_dir, iters, k, every=3, summary=None):
    opt = (optim.LocalOptimizer(mlp(), pipeline(), nn.ClassNLLCriterion(),
                                device="cpu")
           .set_optim_method(optim.SGD(0.05, momentum=0.9))
           .set_steps_per_dispatch(k)
           .set_seed(7)
           .set_end_when(optim.max_iteration(iters))
           .set_checkpoint(ckpt_dir, optim.several_iteration(every)))
    if summary is not None:
        opt.set_train_summary(summary)
    return opt


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dir", required=True)
    p.add_argument("--losses", required=True)
    p.add_argument("--iters", type=int, default=16)
    p.add_argument("--k", type=int, default=1)
    p.add_argument("--every", type=int, default=3)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--preemption", action="store_true")
    p.add_argument("--params-out")
    args = p.parse_args(argv)
    torch.set_num_threads(1)

    opt = build_optimizer(args.dir, args.iters, args.k, every=args.every,
                          summary=LossLog(args.losses))
    if args.preemption:
        opt.set_preemption_handling()
    if args.resume and not opt.resume():
        return 3
    opt.optimize()
    if args.params_out:
        np.savez(args.params_out,
                 **{k: v.detach().numpy()
                    for k, v in opt.model.named_parameters()})
    if opt.state.get("preempted"):
        print(f"PREEMPTED {opt.state['neval']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
