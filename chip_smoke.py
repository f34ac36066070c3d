"""Smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one NVIDIA card.

Drives the port's eight main paths and holds every kernel of them against
its plain PyTorch version.  Serving: an int8-quantized ResNet-50 (1000
classes, 224x224, NCHW, random weights from a seed) served by
``ModelRegistry`` with ``quantize=True`` (weight_only) and
``quantize="dynamic"`` (kernel B4).  Training: PTB-medium (vocab 10000,
650x2 LSTM, T=35, batch 20, f32) trained through ``LocalOptimizer`` in
K=8-step blocks with SGD at lr 1.0 and global-norm clipping at 5.0, layer
0's LSTM cell running kernels B2f and B2b; and ResNet-50 (1000 classes,
224x224, NHWC, bf16 compute, batch 256) trained through ``LocalOptimizer``
in K=4 blocks with the ImageNet recipe's SGD, schedule and augmentation
pipeline, the stem max pool's backward running kernel B1; and the census
Wide&Deep (wide table 100,000 x 1, deep fields 10000/1000/100/100/50 at
embed 16, 13 dense features, MLP (100, 50), batch 8192 with 8 wide ids a
sample, f32) trained through ``LocalOptimizer`` in K=8 blocks with Adam at
lr 0.01 on batch-COO ``SparseMiniBatch`` es, the wide part's forward and
its weight gradient running kernel B3; and LeNet-5 (NCHW f32) trained on
synthetic MNIST at MNIST's counts with the recipe of
``examples/lenet/train.py`` (SGD lr 0.05, momentum 0.9, batch 128, two
epochs, validation and a snapshot every epoch, both summaries), its two
pools' backward running kernel B1; and ResNet-50's ImageNet recipe again,
through ``Optimizer.create(..., distributed=True)``: the data-parallel
``DistriOptimizer`` with the bucketed ZeRO-1 gradient sync at world 1 over
NCCL, the stem pool's backward on B1; and the CIFAR-10 recipes of
``examples/vgg/train.py`` and ``examples/resnet/train_cifar10.py`` (VGG
for CIFAR-10 and ResNet-20, NCHW f32, batch 128, on 50,000 synthetic
images through the recipe's pad/crop/flip pipeline, Top-1 over 10,000),
VGG's five pools on B1; and Inception v1 at ``bench.py``'s configuration
(NHWC, bf16 compute, batch 256, 224x224, 1000 classes) with the recipe of
``examples/inception/train.py``, its 13 pools on B1.  Phases, each
printing its seconds:

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. the kernels, built from ``bigdl_tpu_torch/csrc`` (one ``nvcc`` a
   source, in parallel; build seconds and the ``-Xptxas -v`` report);
3. int8 kernel phase: every distinct GEMM of a batch-32 ResNet-50 forward
   (and the same K, O at 1 and 37 rows), in both modes, with and without
   bias, weight_only in f32 and bf16, against ``int8_matmul_reference``
   on the card (dynamic bitwise, weight_only within ``rtol=1e-5,
   atol=1e-5*max|y|``) and the variant each GEMM took in each mode (the
   SIMT kernel where TMA cannot describe the rows, the wgmma one
   elsewhere), then per shape and summed per forward the kernel's and the
   library call's device time (torch.profiler), event-timed loops of
   kernel, plain version and library call, and the least time the card
   could take (the bound; weight_only's also on the CUDA cores alone);
4. int8 profile phase, per mode: device time by kernel of one batch-32
   forward (torch.profiler) against its wall time;
5. serving phase, per mode: 8 client threads x 16 requests of 1-4 rows,
   then 4 sampled requests served alone that must agree with the same
   model run on the CPU through the plain versions within 1e-5 of
   max|y|, a limit that two planted faults must exceed; the kernel's launch
   count must equal 54 x dispatches (in both modes 1 SIMT, the stem, and
   53 wgmma) and warmup must not grow;
6. LSTM kernel phase: B2f and B2b against their plain versions at the
   six (N, H) shapes of ``CELL_SHAPES``, f32 and bf16, forget_bias 0 and
   1, then their times at (20, 650) f32 beside the bound, the plain
   version and PyTorch's fused cell, with B2f's CTAs and cluster size and
   B2b's grid beside the floor of its launches (an empty kernel of the
   same grid);
7. training phase: one K=8 block on the card against the same steps on
   the CPU through the plain versions (within ``TRAIN_TOL``, a limit two
   planted faults must exceed); four timed blocks (words/s, ms per step,
   peak memory, the loss must fall) whose kernel launches must equal 35 x
   steps each; one step under torch.profiler (device idle share);
8. pool-kernel phase: B1 against its plain version, bitwise, at 20
   geometries (``POOL_CASES``: every branch of both variants), each taking
   the variant ``TILED_CASES`` says, then at the ResNet-50 stem in bf16 and
   f32 its error on the timed inputs and its time beside the bound, the
   plain version and PyTorch's ``max_pool2d_with_indices_backward``;
9. resnet-train timed phase: the recipe twice, 16 steps each, through its
   own pipeline (8 worker threads) and over batches augmented beforehand
   (images/s, ms per step, block losses that must be finite and fall,
   peak memory, B1 launches that must equal the steps, all bf16 and all
   ``tiled_nhwc``), then one profiled step;
10. resnet-train check phase, f32, batch 8, card against CPU: one K=2
   block with the residual gammas at 0 (``grad_reading``), and each of
   the 53 conv+BatchNorm units alone at the model's init
   (``unit_reading``), both within ``RESNET_TRAIN_TOL``, a limit three
   planted faults must exceed;
11. bag-kernel phase: B3 against its plain version, bitwise, forward and
   the swapped-role weight gradient, at the 10 cases of ``BAG_CASES`` (the
   census shape, D 16/128/129, unsorted rows with empty rows and the
   padding tail, bf16, a single row, 64-bit offsets, every entry on one
   key), its grouping passes' (perm, offsets) bitwise against the
   library's ``row_index`` there in both roles and alone at the 7
   ``GROUP_EDGE_CASES`` (keys below 0 and at or above n_keys: offsets in
   full, perm over the bounds, the keys outside each on its side in nnz
   order), then at the
   census shape one call with host syncs made errors, the whole call's
   device time split by kernel (only ``csrc/embed_bag.cu``'s), beside the
   bound, the plain version, ``F.embedding_bag`` on the pre-sorted stream
   and the library route (sort, searchsorted, ``F.embedding_bag``);
12. wide-deep timed phase: the census Wide&Deep twice, 32 steps each,
   through the recipe's feed (``SparseSample`` >> ``batch_sparse_samples``)
   and over batches built beforehand (records/s, ms per step, peak
   memory, block losses that must fall on a planted teacher's labels, B3
   launches that must equal 2 a step), then one profiled step;
13. wide-deep check phase, card against CPU: one K=8 block step by step
   (``wd_step_reading``) within ``WD_TRAIN_TOL``, a limit three planted
   faults must exceed;
14. lenet pool phase: B1 at LeNet's two pools (batch 128: x (128, 6, 24,
   24) and (128, 12, 8, 8), 2x2/2, NCHW f32), bitwise against its plain
   version in ``two_pass``, then on tanh outputs its device time beside
   the bound, the plain version and ``max_pool2d_with_indices_backward``;
15. lenet timed phase: the recipe for two epochs (samples/s, ms per step,
   peak memory, Top-1/Top-5 after each epoch over the 10,000 validation
   images, each snapshot's commit ms and bytes); Top-1 after the last
   epoch must exceed 0.9, the loss must fall and B1 must launch 2 a step
   (validation runs the forward only); one profiled step;
16. lenet check phase, card against CPU: one K=4 block step by step
   (``wd_step_reading``) and the validation log-probabilities of the
   trained weights within ``LENET_TRAIN_TOL``, a limit two planted faults
   must exceed;
17. lenet resume phase, under ``torch.use_deterministic_algorithms``: at
   K=1 and K=4 a run cut by a SIGTERM mid-epoch (preemption handling) and
   resumed by a fresh optimizer must equal the uninterrupted run bitwise,
   losses and weights; at K=4 the preemption's snapshot is truncated on
   disk first and ``latest_valid`` must skip it;
18. distri phase, ResNet-50 through ``DistriOptimizer`` at world 1 over
   NCCL with the f32 wire, then the bf16 wire: a warm-up and three timed
   K=4 blocks over pre-augmented images, a warm-up and one timed block
   through the recipe's pipeline (images/s, ms per step, peak memory, the
   bucket count, block losses that must fall, B1 launches that must equal
   the steps), then one profiled step a wire with the sync's device ms by
   phase (the kernels of the ``grad_sync.<phase>`` ranges);
19. distri vs local: one K=4 block through ``DistriOptimizer`` (f32 wire)
   and through ``LocalOptimizer`` from the same weights and data, LeNet-5
   under ``torch.use_deterministic_algorithms`` and ResNet-50 under
   cuDNN's deterministic algorithms: losses and weights bitwise equal;
20. distri world 2: B1 against its plain version, bitwise, at LeNet's two
   pools at batch 64; two spawned processes on the one card over gloo,
   LeNet at batch 64 a process: the f32 wire bitwise equal to the
   all-reduce path, the ranks equal, the f32 master slices reassembled
   into the weights exactly, the bf16 wire's masters within
   ``WIRE_DRIFT_LIMIT`` of the f32 wire's weights and its published
   weights its masters rounded to bf16, with two planted faults that
   must each fail one of those, B1 two launches a step;
21. distri resume: a grad_sync snapshot at iteration 4 (the reference's
   ``{"master", "opt"}`` layout) resumed by a fresh optimizer ends
   bitwise where the uninterrupted run ends (LeNet, K=4);
22. cifar: B1 at VGG's five pools (``VGG_POOL_CASES``, batch 128, NCHW
   f32, ``two_pass``) bitwise against its plain version, then timed
   beside the bound and the library; VGG one epoch and ResNet-20
   ``CIFAR["steps"]`` steps through LocalOptimizer and VGG
   ``CIFAR["steps"]`` steps through the DistriOptimizer the recipe's
   ``--distributed`` builds (world 1, NCCL), each printing images/s, ms
   a step, peak memory, Top-1 and a profiled step; the loss must fall,
   Top-1 pass ``CIFAR["min_top1"]``, B1 launch 5 times a VGG step (all
   ``two_pass``) and never for ResNet-20;
   then VGG's world-1 DistriOptimizer against LocalOptimizer over a K=4
   block under the deterministic algorithms: bitwise;
23. inception: B1 at Inception v1's 10 distinct NHWC bf16 geometries at
   batch 256 (``tiled_nhwc``) and 3 NCHW f32 ones at batch 4
   (``two_pass``: a 3x3/2 ceil-mode pool, 3x3/1 pad 1 pools), bitwise and
   timed; two timed runs of the recipe (pre-augmented and through its
   pipeline, 16 timed steps each, four blocks an epoch: images/s, ms a
   step, peak memory, a profiled K=4 block's idle share and top
   operations, B1 13 launches a step, all bf16
   ``tiled_nhwc``); then an NCHW f32 Inception v1 (its LRNs at an even
   size and alpha 1, dropout off) through one K=4 block on the card
   against the CPU step by step (``wd_step_reading``, each gradient by
   its norm share) within
   ``INCEPTION_TRAIN_TOL``, a limit two planted faults must exceed (the
   LRN's torch window, two towers of module 4a swapped).

The last lines are the card, the kernel table and the result as JSON; any
failed check raises and the script exits non-zero.  Without a CUDA card it
fails at once.  Run from the repository root:

    python3 chip_smoke.py [--seed N] [--json-out PATH]
                          [--phases resnet,lstm,resnet-train,wide-deep,lenet,
                                    distri,cifar,inception]

``--phases resnet-conditioning`` adds a diagnostic that is not run by
default: the check phase's path reading at residual gammas 0 to 1, beside
the CPU's own reading on reordered batches.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import itertools
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

# cuBLAS's deterministic workspace setting (what the LeNet resume check's
# torch.use_deterministic_algorithms asks for), set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.checkpoint import load_snapshot  # noqa: E402
from bigdl_tpu_torch.checkpoint import manager as ckpt_manager  # noqa: E402
from bigdl_tpu_torch.dataset import (  # noqa: E402
    DataSet, MTSampleToMiniBatch, Sample, SampleToMiniBatch, SparseMiniBatch,
    SparseSample, Transformer, batch_sparse_samples)
from bigdl_tpu_torch.dataset import cifar, image, mnist  # noqa: E402
from bigdl_tpu_torch.dataset.text import Dictionary  # noqa: E402
from bigdl_tpu_torch.engine import Engine  # noqa: E402
from bigdl_tpu_torch.models import (WideAndDeep, inception_v1,  # noqa: E402
                                    lenet5, ptb_model, resnet50,
                                    resnet_cifar, vgg_for_cifar10)
from bigdl_tpu_torch.nn import quantize, recurrent  # noqa: E402
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,  # noqa: E402
                                          QuantizedSpatialConvolution)
from bigdl_tpu_torch.ops import (  # noqa: E402
    _build, embed_bag, int8_gemm, lstm_cell, maxpool)
from bigdl_tpu_torch.ops.int8_gemm import (  # noqa: E402
    int8_matmul_reference, prepare_operands)
from bigdl_tpu_torch.optim import LocalOptimizer  # noqa: E402
from bigdl_tpu_torch.serving import ModelRegistry  # noqa: E402
from bigdl_tpu_torch.transform import vision as V  # noqa: E402
from bigdl_tpu_torch.utils.precision import mixed_precision_loss_fn  # noqa: E402
from bigdl_tpu_torch.utils.summary import (TrainSummary,  # noqa: E402
                                           ValidationSummary)

# H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32 = 67e12       # FLOP/s on the CUDA cores
PEAK_BF16 = 989e12     # FLOP/s on the tensor cores (weight_only's products)
PEAK_INT8 = 1979e12    # OP/s on the tensor cores (dynamic's int8 products)
HBM_BPS = 3.35e12      # bytes/s
BATCH = 32
SPEC = ((3, 224, 224), np.float32)
KERNEL = {"route": "cuda", "source": "bigdl_tpu_torch/csrc/int8_gemm.cu",
          "replaces": "bigdl_tpu/ops/pallas_int8_gemm.py:207"}
# served output against the same model on the CPU, as a share of max|y|:
# weight_only sums in f32 on the card and in float64 on the CPU at each of
# 54 layers; in dynamic mode the GEMMs agree bitwise and only the float
# layers (pooling sums, log-softmax) differ by ulps.  Each limit sits
# between the sound reading and the readings of the planted faults below,
# which the run measures and requires to exceed it.
SERVE_TOL = {"weight_only": 1e-5, "dynamic": 1e-5}

# PTB-medium (bench.py's ptb_lstm workload): vocab 10000, embed and hidden
# 650, 2 LSTM layers, T=35, batch 20, dropout 0, f32, K=8 steps a block
PTB = {"vocab": 10000, "embed": 650, "hidden": 650, "layers": 2, "T": 35,
       "batch": 20, "K": 8}
PTB_BATCHES = 64   # batches per epoch of the synthetic corpus
TIMED_BLOCKS = 3   # K-step blocks timed after one warm-up block
LSTM_KERNELS = {
    "lstm_cell_fwd": {"route": "cuda",
                      "source": "bigdl_tpu_torch/csrc/lstm_cell.cu",
                      "replaces": "bigdl_tpu/ops/pallas_lstm.py:153"},
    "lstm_cell_bwd": {"route": "cuda",
                      "source": "bigdl_tpu_torch/csrc/lstm_cell.cu",
                      "replaces": "bigdl_tpu/ops/pallas_lstm.py:181"},
}
# (N, H): PTB-medium's, tiny, ragged, N above one 32-row batch tile (37, 64),
# and an odd H (333) that the forward's eight K slices do not divide and whose
# bf16 rows take its plain-load copies
CELL_SHAPES = [(20, 650), (1, 64), (5, 130), (37, 650), (64, 650), (20, 333)]
# elementwise operations per hidden unit (transcendentals counted as one)
CELL_EW_OPS = {"lstm_cell_fwd": 20, "lstm_cell_bwd": 36}
# kernel against plain version (rtol = atol): bf16 results within one bf16
# ulp of values up to 2; f32 results within 1e-5 (expf/tanhf within ulps
# of PyTorch's), except the forward's at H=650, where the recurrent product
# sums 650 terms in another order than cuBLAS: 1e-4 there, the JAX cell
# test's own forward tolerance at that shape (tests/test_pallas_kernels.py)
CELL_TOL = {"bfloat16": 8e-3, "float32": 1e-5, "float32 long sum": 1e-4}


def cell_tol(kernel, H, dtype) -> float:
    if dtype == torch.bfloat16:
        return CELL_TOL["bfloat16"]
    long_sum = kernel == "lstm_cell_fwd" and H > 130
    return CELL_TOL["float32 long sum" if long_sum else "float32"]
# card training against the same steps on the CPU (train_reading): above
# the sound reading, below the two planted faults that every run measures
# and requires to exceed it
TRAIN_TOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def gemm_shapes(model, device):
    """[(M, K, O, has_bias)] of one batch-32 forward of the quantized
    ``model``, in launch order, read from the layers' output shapes."""
    rec = []

    def hook(m, inp, out):
        O = m.weight_q.shape[0]
        K = m.weight_q[0].numel()
        M = out.shape[0] * (out.shape[2] * out.shape[3]
                            if out.dim() == 4 else 1)
        rec.append((M, K, O, m.bias is not None))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (QuantizedSpatialConvolution,
                                 QuantizedLinear))]
    with torch.inference_mode():
        model(torch.zeros((BATCH,) + SPEC[0], device=device))
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    return rec


def operands(M, K, O, xdtype, bias, gen, device):
    x = torch.randn(M, K, generator=gen, device=device)
    wq = torch.randint(-127, 128, (O, K), generator=gen, device=device,
                       dtype=torch.int8)
    scale = torch.rand(O, generator=gen, device=device) * 0.02 + 0.001
    b = torch.randn(O, generator=gen, device=device) if bias else None
    if xdtype == "int8":
        xin, scale = prepare_operands(x, scale, "dynamic")
        return xin, wq, scale, b
    return x.to(getattr(torch, xdtype)), wq, scale, b


def cuda_ms(fn, budget_ms=30.0):
    """Mean milliseconds of ``fn`` on the card, after a warmup call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    iters = int(min(100, max(3, budget_ms / max(start.elapsed_time(end),
                                                1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sentinel():
    """A short spin kernel at the head of a profiled window, waited for:
    the trace can miss a session's first launches, and these it may miss.
    :func:`device_time` leaves it out."""
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


def per_call_ms(kernels, calls):
    """{kernel: device ms per call} from a trace of ``calls`` calls: each
    kernel's mean time over the launches the trace holds, times its
    launches per call (a kernel seen fewer than calls / 2 times is no part
    of a call).  The trace can drop a launch or two of a long session, so
    a plain sum over the trace would read a little low."""
    return {name: ms / n * round(n / calls)
            for name, ms, n in kernels if round(n / calls) > 0}


def profiled_kernels(run, tries=8):
    """The kernels list (:func:`device_time`) of one torch.profiler session
    around ``run()``, after the :func:`sentinel`.  Now and then a session's
    trace holds no kernel at all, sometimes three in a row; such a session
    is taken again after a short pause, up to ``tries`` times, then
    fails."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(tries):
        if i:
            time.sleep(0.2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sentinel()
            run()
            torch.cuda.synchronize()
        _, kernels, _ = device_time(prof)
        if kernels:
            return kernels
        print("profiler: a trace held no kernel; taken again")
    raise AssertionError(f"the profiler saw no device time in {tries} "
                         f"sessions")


def device_ms(fn, calls=50, split=None):
    """Device milliseconds of one call of ``fn``: the device time of the
    kernels it launches (torch.profiler) over ``calls`` calls after a
    warmup, per call (:func:`per_call_ms`).  The host's gaps between
    launches are left out; for a call of a few microseconds of device
    work they are most of what :func:`cuda_ms` measures.  A ``split``
    list receives (kernel, ms per call) of each kernel."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()

    for _ in range(3):  # a trace that lost most launches is taken again
        kernels = profiled_kernels(run)
        per_call = per_call_ms(kernels, calls)
        if per_call:
            break
        print(f"profiler: a trace lost most launches of {calls} calls ("
              + ", ".join(f"{n} x{c}" for n, _, c in kernels)[:300]
              + "); taken again")
    else:
        raise AssertionError("the profiler saw no kernel of every call")
    if split is not None:
        split += list(per_call.items())
    return sum(per_call.values())


def gemm_device_ms(k_fn, l_fn, calls=20):
    """(kernel, library) device milliseconds a call: ``calls`` calls of each
    after a warmup, in one torch.profiler session, per call
    (:func:`per_call_ms`), the port's kernels told from the library's by
    name (``gemm_dynamic*``, ``gemm_weight_only``); library None when
    ``l_fn`` is None."""
    fns = [k_fn] + ([l_fn] if l_fn is not None else [])
    for fn in fns:
        fn()
    torch.cuda.synchronize()

    def run():
        for fn in fns:
            for _ in range(calls):
                fn()

    def ours(name):
        return "gemm_dynamic" in name or "gemm_weight_only" in name

    for _ in range(3):  # a trace that lost the kernel's launches: again
        per_call = per_call_ms(profiled_kernels(run), calls)
        mine = sum(ms for name, ms in per_call.items() if ours(name))
        if mine > 0:
            break
        print("profiler: a trace lost the kernel's launches; taken again")
    else:
        raise AssertionError("the profiler saw no device time of the kernel")
    lib = sum(per_call.values()) - mine
    return mine, (lib if l_fn is not None else None)


def bound(M, K, O, bias, xdtype, cuda_cores=False):
    """(least ms, "bytes" | "operations", peak used) for one GEMM: each
    input read once, the output written once, against the card's memory
    rate and the peak rate of the operations.  int8 x: int8 products on
    the tensor cores.  f32 x: three exact bf16 products a term on the
    tensor cores (each f32 value is the sum of three bf16 terms, the
    kernel's split), bf16 x one; with ``cuda_cores`` instead one f32 FMA a
    term on the CUDA cores."""
    xbytes = {"float32": 4, "bfloat16": 2, "int8": 1}[xdtype]
    nbytes = M * K * xbytes + O * K + 4 * O * (2 if bias else 1) + 4 * M * O
    ops = 2.0 * M * K * O
    if xdtype == "int8":
        peak = PEAK_INT8
    elif cuda_cores:
        peak = PEAK_F32
    else:
        peak = PEAK_BF16
        ops *= 3 if xdtype == "float32" else 1
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", peak)


def library_call(xin, wq, scale, b, xdtype):
    """One PyTorch call for the same product, or None where its shape
    rules refuse: addmm/mm on dequantized weights (weight_only), _int_mm
    (dynamic, int32 product only).  _int_mm wants K a multiple of 8, so a
    ragged K (the stem's 147) is padded with zero columns on both sides,
    outside the timed call: they leave the integer product unchanged.  A
    yardstick; the port never calls it."""
    if xdtype != "int8":
        w = (wq.float() * scale[:, None]).T
        x = xin.float()
        return (lambda: torch.addmm(b, x, w)) if b is not None \
            else (lambda: torch.mm(x, w))
    M, K = xin.shape
    if M <= 16 or wq.shape[0] % 8:
        return None
    pad = -K % 8
    xp = torch.nn.functional.pad(xin, (0, pad))
    wt = torch.nn.functional.pad(wq, (0, pad)).T
    try:
        torch._int_mm(xp, wt)
    except RuntimeError:
        return None
    return lambda: torch._int_mm(xp, wt)


def kernel_phase(shapes, device, card, report):
    gen = torch.Generator(device=device).manual_seed(1234)
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    errs = {"float32": 0.0, "bfloat16": 0.0, "int8": 0.0}
    n_checked = 0
    variants = {}  # (m, K, O, xdtype) -> the variant the C entry point took
    for (M, K, O, _) in counts:
        for m in (M, 1, 37):
            for xdtype in ("float32", "bfloat16", "int8"):
                for bias in (False, True):
                    xin, wq, scale, b = operands(m, K, O, xdtype, bias, gen,
                                                 device)
                    got = int8_gemm.launch(xin, wq, scale, b)
                    variants[m, K, O, xdtype] = int8_gemm.last_variant
                    want = int8_matmul_reference(xin, wq, scale, b)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    errs[xdtype] = max(errs[xdtype], err)
                    n_checked += 1
                    if xdtype == "int8":
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"dynamic kernel not bitwise at M={m} K={K} "
                                f"O={O} bias={bias}: max err {err}")
                    else:
                        torch.testing.assert_close(
                            got, want, rtol=1e-5,
                            atol=1e-5 * want.abs().max().item(),
                            msg=lambda e: f"{xdtype} M={m} K={K} O={O}: {e}")
                    del xin, wq, scale, b, got, want
    print(f"kernel check: {n_checked} GEMMs vs int8_matmul_reference; "
          f"dynamic bitwise; max abs err f32 {errs['float32']:.3e} "
          f"bf16 {errs['bfloat16']:.3e} int8 {errs['int8']:.3e}")
    taken = {}
    for (m, K, O, xdtype), v in variants.items():
        taken.setdefault((xdtype, v[0]), []).append(f"{m}x{K}x{O}")
    for (xdtype, v), cases in sorted(taken.items()):
        print(f"  x {xdtype} variant {v}: {len(cases)} checked shapes "
              f"({', '.join(cases[:6])}{', ...' if len(cases) > 6 else ''})")

    totals = {}
    for (M, K, O, bias), n in counts.items():
        for xdtype in ("float32", "int8"):
            mode = "dynamic" if xdtype == "int8" else "weight_only"
            xin, wq, scale, b = operands(M, K, O, xdtype, bias, gen, device)
            k_fn = lambda: int8_gemm.launch(xin, wq, scale, b)  # noqa: E731
            lib = library_call(xin, wq, scale, b, xdtype)
            # device time (torch.profiler): the kernel and the library call
            # in one session, told apart by the kernels' names
            k_ms, l_ms = gemm_device_ms(k_fn, lib)
            variant = int8_gemm.last_variant
            # event-timed loops, the host's launch gaps included
            k_ev = cuda_ms(k_fn)
            p_ev = cuda_ms(lambda: int8_matmul_reference(xin, wq, scale, b),
                           budget_ms=10.0)
            l_ev = cuda_ms(lib) if lib is not None else None
            b_ms, b_by, peak = bound(M, K, O, bias, xdtype)
            c_ms = bound(M, K, O, bias, xdtype, cuda_cores=True)[0]
            row = {"mode": mode, "M": M, "K": K, "O": O, "bias": bias,
                   "launches_per_forward": n, "variant": list(variant),
                   "kernel_ms": k_ms, "library_ms": l_ms,
                   "kernel_event_ms": k_ev, "plain_event_ms": p_ev,
                   "library_event_ms": l_ev, "bound_ms": b_ms,
                   "bound_by": b_by, "peak": peak}
            if mode == "weight_only":
                row["bound_cuda_cores_ms"] = c_ms
            report["shapes"].append(row)
            fmt = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
            cores = (f", CUDA cores {c_ms:.4f}" if mode == "weight_only"
                     else "")
            print(f"gemm {mode:11s} M={M:6d} K={K:4d} O={O:4d} "
                  f"bias={int(bias)} x{n} {variant[0]} tile {variant[1]}x"
                  f"{variant[2]} stages {variant[3]} blocks {variant[4]}: "
                  f"device ms kernel={k_ms:.4f} library={fmt(l_ms)} "
                  f"bound={b_ms:.4f} ({b_by}, peak {peak / 1e12:.0f}T"
                  f"{cores}); event-timed kernel={k_ev:.4f} "
                  f"plain={p_ev:.4f} library={fmt(l_ev)} [{card}]")
            t = totals.setdefault(mode, {
                "ms": 0.0, "event_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_cuda_cores_ms": 0.0, "library_ms": 0.0,
                "library_event_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                "variants": {}})
            t["ms"] += n * k_ms
            t["event_ms"] += n * k_ev
            t["plain_ms"] += n * p_ev
            t["bound_ms"] += n * b_ms
            t["bound_cuda_cores_ms"] += n * c_ms
            for key, v in (("library_ms", l_ms), ("library_event_ms", l_ev)):
                t[key] = None if v is None or t[key] is None \
                    else t[key] + n * v
            t["bytes_ms" if b_by == "bytes" else "ops_ms"] += n * b_ms
            t["variants"][variant[0]] = t["variants"].get(variant[0], 0) + n
            del xin, wq, scale, b
    for mode, t in totals.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        cores = (f" (CUDA cores alone {t['bound_cuda_cores_ms']:.4f})"
                 if mode == "weight_only" else "")
        print(f"gemm {mode} per batch-{BATCH} forward ({sum(counts.values())} "
              f"launches: {t['variants']}): device ms kernel={t['ms']:.4f} "
              f"library={lib} bound={t['bound_ms']:.4f}{cores}; event-timed "
              f"kernel={t['event_ms']:.4f} plain={t['plain_ms']:.4f} "
              f"[{card}]")
    for mode, t in totals.items():
        t["max_abs_err"] = errs["int8" if mode == "dynamic" else "float32"]
    return totals


def device_time(prof):
    """(device busy ms, kernels, ops) of a torch.profiler run, each of the
    two a [(name, device ms, calls)] list by time.  Busy is the sum over
    the kernel-side events (each launch counted once).  The ops are the
    host-side aten operations that launched kernels and carry the same
    device time; the port's own kernels, launched through ctypes, appear
    only among the kernels.  The :func:`sentinel` spin and the device
    spans of ``record_function`` ranges (user annotations, idle gaps
    included) are left out."""
    from torch.autograd import DeviceType
    events = prof.key_averages()

    def by_time(kind):
        return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in events if e.device_type == kind
                       and e.self_device_time_total > 0
                       and not getattr(e, "is_user_annotation", False)
                       and "spin_kernel" not in e.key
                       and e.key != "aten::_sleep"),
                      key=lambda t: -t[1])
    kernels = by_time(DeviceType.CUDA)
    return sum(ms for _, ms, _ in kernels), kernels, by_time(DeviceType.CPU)


def profile_step(step, label, card, top):
    """One call of ``step`` (a training step) under torch.profiler after a
    warm-up call: prints (:func:`print_profile`, the ``top`` kernels and
    operations) and returns wall ms, device busy ms, the idle share, kernel
    launches and the 20 first device kernels and aten operations."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t1) * 1e3
    busy_ms, kernels, ops = device_time(prof)
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": max(0.0, 1 - busy_ms / wall_ms) if busy_ms
           else None,
           "kernel_launches": sum(n for _, _, n in kernels),
           "kernels": [list(k) for k in kernels[:20]],
           "ops": [list(o) for o in ops[:20]]}
    print_profile(label, out, card, top)
    return out


def print_profile(label, prof, card, top=None):
    """Prints a profile (:func:`profile_step`, :func:`profiled_block`):
    wall ms, device busy ms, the idle share, kernel launches and the
    ``top`` device kernels and aten operations (all it holds: None)."""
    idle = "not measured (the profiler saw no device time)" \
        if not prof.get("device_busy_ms") else f"{prof['idle_share']:.3f}"
    print(f"profile {label}: wall_ms={prof['wall_ms']:.2f} device_busy_ms="
          f"{prof['device_busy_ms']:.2f} idle_share={idle} kernel_launches="
          f"{prof['kernel_launches']} [{card}]")
    busy = prof["device_busy_ms"]
    for name, ms, n in (prof["kernels"][:top]
                        + [["--- aten ops ---", 0.0, 0]] + prof["ops"][:top]):
        share = 100 * ms / busy if busy else 0.0
        print(f"  {ms:8.3f} ms {share:5.1f}% x{n:<5d} {name[:90]}")


def profile_phase(mode, seed, device, card, report):
    """Where one batch-32 forward's time goes: torch.profiler's device
    time by kernel over one forward after a warmup, against the forward's
    host-clock wall time (device idle share = 1 - busy / wall)."""
    from torch.profiler import ProfilerActivity, profile
    model = quantize(resnet50().initialize(seed), mode=mode).to(device)
    x = torch.randn((BATCH,) + SPEC[0], device=device)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    busy_ms, kernels, ops = device_time(prof)
    gemm_ms = sum(ms for name, ms, _ in kernels if "gemm_" in name)
    if busy_ms == 0:
        print(f"profile {mode}: the profiler saw no device time; device "
              f"breakdown not measured (wall_ms={wall_ms:.2f}) [{card}]")
        report["profile"][mode] = {"wall_ms": wall_ms, "device": None}
        return
    print(f"profile {mode} batch {BATCH}: wall_ms={wall_ms:.2f} "
          f"device_busy_ms={busy_ms:.2f} idle_share="
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; int8_gemm {gemm_ms:.3f} "
          f"ms ({100 * gemm_ms / busy_ms:.1f}%) [{card}]")
    for name, ms, n in ops[:8]:
        print(f"  {ms:8.3f} ms {100 * ms / busy_ms:5.1f}% x{n:<4d} {name}")
    report["profile"][mode] = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "int8_gemm_ms": gemm_ms,
        "ops": {name: {"ms": ms, "count": n} for name, ms, n in ops}}


def serving_phase(mode, seed, device, card, report):
    model = resnet50().initialize(torch.Generator().manual_seed(seed))
    torch.cuda.reset_peak_memory_stats()
    with ModelRegistry(device=device) as reg:
        t0 = time.monotonic()
        svc = reg.deploy("resnet50", model, input_spec=SPEC, max_batch_size=BATCH,
                         quantize=True if mode == "weight_only" else mode)
        deploy_s = time.monotonic() - t0
        warm = svc.compile_count
        if warm != len(svc.buckets):
            raise AssertionError(f"warmup ran {warm} forwards for "
                                 f"{len(svc.buckets)} buckets")
        errors = []

        def client(tid):
            rng = np.random.default_rng(seed * 100 + tid)
            try:
                for _ in range(16):
                    x = rng.normal(0, 1, (int(rng.integers(1, 5)),)
                                   + SPEC[0]).astype(np.float32)
                    y = reg.predict("resnet50", x, timeout=300)
                    if y.shape != (len(x), 1000) or not np.isfinite(y).all():
                        raise AssertionError(f"bad output {y.shape}")
            except Exception as e:  # re-raised below
                errors.append(e)

        int8_gemm.reset_counts()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"client failures: {errors[:3]}")
        stats = svc.stats()
        # the 4 sampled requests go alone: in dynamic mode the activation
        # scale is per dispatched batch, so a coalesced request's output
        # depends on its neighbours and only a lone one has a CPU twin
        rng = np.random.default_rng(seed)
        samples = [rng.normal(0, 1, (int(rng.integers(1, 5)),)
                              + SPEC[0]).astype(np.float32) for _ in range(4)]
        served = [reg.predict("resnet50", x, timeout=300) for x in samples]
        launches = int8_gemm.launches
        variants = {v: n for v, n in int8_gemm.variant_launches.items() if n}
        dispatches = svc.stats()["dispatch_count"]
        peak_mem = torch.cuda.max_memory_allocated()
    if launches != 54 * dispatches or dispatches == 0:
        raise AssertionError(f"{mode}: {launches} kernel launches for "
                             f"{dispatches} dispatches (want 54 each)")
    # the stem's K=147 int8 weight rows are no 16-byte multiple, so it takes
    # the SIMT variant; the 53 others the wgmma one
    want = {f"simt_{mode}": dispatches, f"wgmma_{mode}": 53 * dispatches}
    if variants != want:
        raise AssertionError(f"{mode}: variant launches {variants}, want "
                             f"{want}")
    if stats["compile_count"] != warm or stats["requests_failed"]:
        raise AssertionError(f"{mode}: warmup grew or requests failed: "
                             f"{stats}")
    cpu_model = quantize(model, mode=mode)
    with torch.inference_mode():
        wants = [cpu_model(torch.from_numpy(x)).numpy() for x in samples]
    for y, want in zip(served, wants):
        np.testing.assert_allclose(
            y, want, rtol=SERVE_TOL[mode],
            atol=SERVE_TOL[mode] * np.abs(want).max())
    worst = max(rel_err(y, want) for y, want in zip(served, wants))
    faults = planted_fault_errors(model, mode, samples, wants, device)
    for fault, err in faults.items():
        if not err > SERVE_TOL[mode]:
            raise AssertionError(
                f"{mode}: planted fault {fault} reads {err:.3e}, inside the "
                f"served tolerance {SERVE_TOL[mode]}: the check is blind")
    print(f"served-vs-cpu check {mode}: sound {worst:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {SERVE_TOL[mode]}) [{card}]")
    lat = stats["latency_ms"]
    print(f"serve {mode}: {stats['requests_completed']} rows in "
          f"{stats['dispatch_count']} coalesced dispatches + 4 lone; "
          f"{launches} kernel launches for {dispatches} dispatches "
          f"({variants}), "
          f"throughput_rps={stats['throughput_rps']} "
          f"p50_ms={lat['p50']} p99_ms={lat['p99']} "
          f"occupancy={stats['mean_batch_occupancy']} "
          f"compile_count={stats['compile_count']} deploy_s={deploy_s:.2f} "
          f"wall_s={wall:.2f} max_memory_allocated={peak_mem} "
          f"cpu_rel_err={worst:.3e} (tol {SERVE_TOL[mode]}) [{card}]")
    report["serving"][mode] = {
        "stats": stats, "launches": launches, "variant_launches": variants,
        "deploy_s": deploy_s,
        "wall_s": wall, "max_memory_allocated": peak_mem,
        "cpu_rel_err": worst, "planted_fault_rel_err": faults}
    return launches


def rel_err(y, want) -> float:
    return float(np.abs(y - want).max() / np.abs(want).max())


def planted_fault_errors(model, mode, samples, wants, device):
    """{fault: largest error, as a share of max|y|, of the quantized
    ``model`` run on the card with that fault planted, against the sound
    CPU outputs ``wants``}.  The faults: every quantized layer's input
    rounded to bf16, and one mid-network conv's weight scales off by
    127/128 (a quantizer that divides by 128)."""
    out = {}
    for fault in ("bf16_activations", "one_scale_127_128"):
        qm = quantize(model, mode=mode).to(device)
        layers = [m for m in qm.modules() if isinstance(
            m, (QuantizedSpatialConvolution, QuantizedLinear))]
        if fault == "bf16_activations":
            for m in layers:
                m.register_forward_pre_hook(
                    lambda m, args: (args[0].bfloat16().float(),))
        else:
            layers[len(layers) // 2].weight_scale.mul_(127 / 128)
        with torch.inference_mode():
            out[fault] = max(
                rel_err(qm(torch.from_numpy(x).to(device)).cpu().numpy(), w)
                for x, w in zip(samples, wants))
        del qm
    return out


# ------------------------------------------------------------- LSTM cell
def cell_operands(N, H, dtype, gen, device):
    """zx, h, c, w_t, dh, dc at (N, H), N(0, 0.5^2), in ``dtype``."""
    mk = lambda *s: (0.5 * torch.randn(*s, generator=gen,  # noqa: E731
                                       device=device)).to(dtype)
    return (mk(N, 4 * H), mk(N, H), mk(N, H), mk(H, 4 * H), mk(N, H),
            mk(N, H))


def cell_bound(N, H, dtype, kernel):
    """(least ms, "bytes" | "operations") of one launch: each input read
    once and each output written once, against the card's memory rate and
    the f32 CUDA-core peak.  Operations: the forward's recurrent product
    (2*N*H*4H) plus the elementwise chain, counted as CELL_EW_OPS per
    hidden unit (a transcendental function counts as one)."""
    es = torch.tensor([], dtype=dtype).element_size()
    NH, G = N * H, 4 * N * H
    if kernel == "lstm_cell_fwd":  # zx, h, c, w_t in; h', c', z out
        nbytes = es * (G + 2 * NH + 4 * H * H) + es * 2 * NH + 4 * G
        ops = 2 * NH * 4 * H + CELL_EW_OPS[kernel] * NH
    else:  # z, c, dh, dc in; dz, dc_prev out
        nbytes = 4 * G + es * 3 * NH + 4 * G + es * NH
        ops = CELL_EW_OPS[kernel] * NH
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lstm_kernel_phase(device, card, report):
    """B2f and B2b against their plain versions at every shape, dtype and
    forget_bias of CELL_SHAPES, then kernel, plain and library times at
    PTB-medium's (20, 650) f32, W_t warm in L2 as the 35 steps of a
    sequence find it: device time per call (torch.profiler) and, beside
    it, a CUDA-event-timed loop that includes the host's launch gaps."""
    gen = torch.Generator(device=device).manual_seed(4321)
    errs = {(k, d): 0.0 for k in LSTM_KERNELS for d in ("float32",
                                                       "bfloat16")}
    n_checked = 0
    for N, H in CELL_SHAPES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            for fb in (0.0, 1.0):
                zx, h, c, w_t, dh, dc = cell_operands(N, H, dtype, gen, device)
                got = lstm_cell.launch_fwd(zx, h, c, w_t, fb)
                want = lstm_cell.lstm_cell_fwd_reference(zx, h, c, w_t, fb)
                # the backward of both from the kernel's own z
                got_b = lstm_cell.launch_bwd(got[2], c, dh, dc, fb)
                want_b = lstm_cell.lstm_cell_bwd_reference(got[2], c, dh, dc,
                                                           fb)
                torch.cuda.synchronize()
                for kernel, gs, ws in (("lstm_cell_fwd", got, want),
                                       ("lstm_cell_bwd", got_b, want_b)):
                    for g, w in zip(gs, ws):
                        tol = cell_tol(kernel, H, g.dtype)
                        torch.testing.assert_close(
                            g.float(), w.float(), rtol=tol, atol=tol,
                            msg=lambda e: f"{kernel} N={N} H={H} {dname} "
                                          f"fb={fb}: {e}")
                        errs[kernel, dname] = max(
                            errs[kernel, dname],
                            (g.float() - w.float()).abs().max().item())
                n_checked += 1
    print(f"lstm kernel check: B2f and B2b at {n_checked} (shape, dtype, "
          f"forget_bias) cases vs their plain versions; max abs err "
          + ", ".join(f"{k} {d} {v:.3e}" for (k, d), v in errs.items())
          + f" (tol {CELL_TOL}) [{card}]")

    N, H = PTB["batch"], PTB["hidden"]
    zx, h, c, w_t, dh, dc = cell_operands(N, H, torch.float32, gen, device)
    # PyTorch's fused cell takes both biases or neither (its CUDA version
    # reads the hidden bias's strides when the input bias is given);
    # forget_bias, 0 here, would go in the input bias's f segment
    ib, hb = torch.zeros(4 * H, device=device), torch.zeros(4 * H, device=device)
    _, _, z = lstm_cell.launch_fwd(zx, h, c, w_t, 0.0)
    hy, cy, ws = torch.ops.aten._thnn_fused_lstm_cell(zx, h @ w_t, c, ib, hb)
    ref = lstm_cell.lstm_cell_fwd_reference(zx, h, c, w_t, 0.0)
    torch.testing.assert_close((hy, cy), ref[:2], rtol=1e-5, atol=1e-5)
    fns = {
        "lstm_cell_fwd": (
            lambda: lstm_cell.launch_fwd(zx, h, c, w_t, 0.0),
            lambda: lstm_cell.lstm_cell_fwd_reference(zx, h, c, w_t, 0.0),
            lambda: torch.ops.aten._thnn_fused_lstm_cell(
                zx, torch.mm(h, w_t), c, ib, hb),
            "2 calls: torch.mm(h, w_t) + torch._thnn_fused_lstm_cell"),
        "lstm_cell_bwd": (
            lambda: lstm_cell.launch_bwd(z, c, dh, dc, 0.0),
            lambda: lstm_cell.lstm_cell_bwd_reference(z, c, dh, dc, 0.0),
            lambda: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
                dh, dc, c, cy, ws, True),
            "torch._thnn_fused_lstm_cell_backward_impl (workspace of "
            "activated gates, not z)")}
    rows = {}
    for kernel, (k_fn, p_fn, l_fn, l_what) in fns.items():
        # ms: device time per call; event_ms: a loop of calls timed with
        # CUDA events, host launch gaps included
        k_ms, p_ms, l_ms = (device_ms(f) for f in (k_fn, p_fn, l_fn))
        k_ev, p_ev, l_ev = (cuda_ms(f) for f in (k_fn, p_fn, l_fn))
        b_ms, b_by = cell_bound(N, H, torch.float32, kernel)
        rows[kernel] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "library_call": l_what, "bound_ms": b_ms,
                        "bound_by": b_by,
                        "max_abs_err": errs[kernel, "float32"],
                        "max_abs_err_bf16": errs[kernel, "bfloat16"],
                        "event_ms": k_ev, "plain_event_ms": p_ev,
                        "library_event_ms": l_ev}
        grid = ""
        if kernel == "lstm_cell_fwd":
            ctas, cluster, copy_bytes, tile = lstm_cell.last_fwd_shape
            rows[kernel].update(ctas=ctas, cluster=cluster,
                                copy_bytes=copy_bytes)
            grid = (f" [{ctas} CTAs in clusters of {cluster}, "
                    f"{copy_bytes}-byte copies, batch tile {tile}]")
        else:  # the floor: an empty kernel of B2b's grid, timed alike
            blocks, threads = lstm_cell.last_bwd_shape
            if lstm_cell.launch_bwd_empty(z, c, dh, dc) != (blocks, threads):
                raise AssertionError("the empty kernel's grid is not B2b's")
            f_ms = device_ms(lambda: lstm_cell.launch_bwd_empty(z, c, dh,
                                                                dc))
            rows[kernel].update(blocks=blocks, threads=threads,
                                floor_ms=f_ms)
            grid = (f" [{blocks} blocks of {threads} threads, one hidden "
                    f"unit a thread; floor_ms={f_ms:.5f} (an empty kernel "
                    f"of that grid), kernel/floor {k_ms / f_ms:.3f}]")
        beats = " (faster than its HBM bound: W_t is read from L2)" \
            if k_ms < b_ms else ""
        print(f"{kernel} N={N} H={H} f32{grid}, device ms per call: "
              f"kernel_ms={k_ms:.5f} plain_ms={p_ms:.5f} "
              f"library_ms={l_ms:.5f} [{l_what}] bound_ms={b_ms:.5f} "
              f"({b_by}){beats}; event-timed loop with host launch gaps: "
              f"kernel {k_ev:.5f} plain {p_ev:.5f} library {l_ev:.5f} "
              f"[{card}]")
    report["lstm_kernels"] = rows
    return rows


# ------------------------------------------------------- PTB-medium training
def ptb_samples(seed):
    """(x, next-word) windows of T words from the synthetic Zipf corpus of
    examples/languagemodel/train_ptb.py at vocab 10000: PTB_BATCHES
    batches of 20 per epoch."""
    rng = np.random.default_rng(seed)
    n = PTB["batch"] * PTB["T"] * PTB_BATCHES + 1
    words = [f"w{min(int(z), PTB['vocab'] - 2)}" for z in rng.zipf(1.4, n)]
    ids = Dictionary([words], vocab_size=PTB["vocab"]).encode(words)
    T = PTB["T"]
    xs, ys = ids[:-1].reshape(-1, T), ids[1:].reshape(-1, T)
    return [Sample(x, y) for x, y in zip(xs, ys)]


def ptb_train(model, device, steps, samples, seed):
    """Train ``model`` in place for ``steps`` steps of the PTB-medium recipe
    through LocalOptimizer; (per-step losses, optimizer, wall seconds)."""
    losses = []

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])

    opt = (Recording(model, DataSet.array(samples, seed=seed)
                     >> SampleToMiniBatch(PTB["batch"]),
                     nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
                     device=device)
           .set_optim_method(optim.SGD(learning_rate=1.0))
           .set_gradient_clipping_by_l2_norm(5.0)
           .set_steps_per_dispatch(PTB["K"])
           .set_seed(seed)
           .set_end_when(optim.max_iteration(steps)))
    t0 = time.monotonic()
    opt.optimize()
    return losses, opt, time.monotonic() - t0


def flat_params(model):
    return {k: p.detach().cpu().double() for k, p in model.named_parameters()}


def train_reading(losses, model, want_losses, want, init):
    """How far a run is from the CPU run: the larger of the largest
    relative loss difference over the steps and, over the parameter
    arrays, the largest difference as a share of the largest change that
    training made to that array on the CPU."""
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    got = flat_params(model)
    param_err = max(((got[k] - want[k]).abs().max()
                     / (want[k] - init[k]).abs().max()).item() for k in want)
    return max(loss_err, param_err)


def planted_lstm_fault(fault):
    """A wrapper of the fused cell as the LSTM layer calls it, planting
    ``fault`` on the card run: layer 0's W_t scaled by 127/128, or one
    time step's layer-0 dz (the gradient reaching zx_t) scaled by 127/128
    through a tensor hook."""
    sound = recurrent.lstm_cell
    calls = [0]

    def cell(zx, h, c, w_t, **kw):
        if fault == "w_t_127_128":
            return sound(zx, h, c, w_t * (127 / 128), **kw)
        calls[0] += 1
        if calls[0] % PTB["T"] == PTB["T"] // 2:
            zx.register_hook(lambda g: g * (127 / 128))
        return sound(zx, h, c, w_t, **kw)
    return cell


def training_phase(seed, device, card, report):
    """PTB-medium trained through LocalOptimizer on the card: one K=8
    block against the same steps on the CPU (and two planted faults), then
    timed blocks, the launch counts, peak memory and one profiled step."""
    samples = ptb_samples(seed)
    init = ptb_model(PTB["vocab"], PTB["embed"], PTB["hidden"],
                     PTB["layers"]).initialize(seed)
    start = flat_params(init)
    K = PTB["K"]

    t0 = time.monotonic()
    cpu_model = copy.deepcopy(init)
    cpu_losses, _, cpu_s = ptb_train(cpu_model, "cpu", K, samples, seed)
    want = flat_params(cpu_model)
    card_model = copy.deepcopy(init)
    card_losses, _, _ = ptb_train(card_model, device, K, samples, seed)
    sound = train_reading(card_losses, card_model, cpu_losses, want, start)
    faults = {}
    for fault in ("w_t_127_128", "one_step_dz_127_128"):
        m = copy.deepcopy(init)
        recurrent.lstm_cell = planted_lstm_fault(fault)
        try:
            losses, _, _ = ptb_train(m, device, K, samples, seed)
        finally:
            recurrent.lstm_cell = lstm_cell.lstm_cell
        faults[fault] = train_reading(losses, m, cpu_losses, want, start)
    print(f"train-vs-cpu check, {K} steps: sound {sound:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {TRAIN_TOL}); cpu losses {cpu_losses[0]:.4f} -> "
          f"{cpu_losses[-1]:.4f} in {cpu_s:.1f} s [{card}]")
    if not sound <= TRAIN_TOL:
        raise AssertionError(f"card training is {sound:.3e} from the CPU, "
                             f"over the limit {TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the training "
                f"tolerance {TRAIN_TOL}: the check is blind")
    print(f"phase train-vs-cpu: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    ptb_train(copy.deepcopy(init), device, K, samples, seed)  # warm-up
    _, _, one_s = ptb_train(copy.deepcopy(init), device, K, samples, seed)
    steps = K * (1 + TIMED_BLOCKS)
    torch.cuda.reset_peak_memory_stats()
    lstm_cell.fwd_launches = lstm_cell.bwd_launches = 0
    losses, opt, all_s = ptb_train(copy.deepcopy(init), device, steps,
                                   samples, seed)
    launches = {"lstm_cell_fwd": lstm_cell.fwd_launches,
                "lstm_cell_bwd": lstm_cell.bwd_launches}
    peak = torch.cuda.max_memory_allocated()
    for kernel, n in launches.items():
        if n != PTB["T"] * steps:
            raise AssertionError(f"{kernel} launched {n} times in {steps} "
                                 f"steps (want {PTB['T']} a step)")
    if not np.mean(losses[-K:]) < np.mean(losses[:K]):
        raise AssertionError(f"the loss did not fall: {losses}")
    step_s = (all_s - one_s) / (steps - K)
    words = PTB["batch"] * PTB["T"]
    print(f"train ptb-medium K={K}: {steps} steps in {all_s:.3f} s, {K} in "
          f"{one_s:.3f} s (each run includes the model's copy to and from "
          f"the card); the {TIMED_BLOCKS} later blocks: "
          f"ms_per_step={step_s * 1e3:.3f} words_per_s={words / step_s:.1f} "
          f"max_memory_allocated={peak} loss {np.mean(losses[:K]):.4f} -> "
          f"{np.mean(losses[-K:]):.4f}; launches {launches} "
          f"(allow_tf32 False) [{card}]")
    print(f"phase train-timed: {time.monotonic() - t0:.1f} s")

    # one step of the same recipe, profiled after a warm-up step
    net = copy.deepcopy(init).to(device).train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    sgd = optim.SGD(learning_rate=1.0)
    x = torch.from_numpy(np.stack([s.feature for s in samples[:20]])).to(
        device)
    y = torch.from_numpy(np.stack([s.label for s in samples[:20]])).to(
        device)

    def step():
        for p in params.values():
            p.grad = None
        crit.apply(net(x), y).backward()
        grads = optim.clip_by_global_norm(
            {k: p.grad for k, p in params.items()}, 5.0)
        sgd.update(grads, params, {}, 1.0, 0)

    prof = profile_step(step, "train step", card, 6)
    report["training"] = {
        "sound": sound, "planted_faults": faults, "tol": TRAIN_TOL,
        "cpu_losses": cpu_losses, "card_losses": card_losses,
        "timed_losses": losses, "steps": steps, "all_s": all_s,
        "one_block_s": one_s, "ms_per_step": step_s * 1e3,
        "words_per_s": words / step_s, "max_memory_allocated": peak,
        "launches": launches, "profile": prof}
    del net, params
    return launches


# ------------------------------------------------------------- max-pool B1
POOL_KERNEL = {"route": "cuda", "source": "bigdl_tpu_torch/csrc/maxpool_bwd.cu",
               "replaces": "bigdl_tpu/ops/pallas_pool.py:165"}
# (name, (N, C, H, W), kernel, stride, pad, ceil_mode, format, dtype, input),
# kernel, stride and pad an int or (h, w): ResNet-50's stem at batch 256 in
# both formats and dtypes, its post-ReLU case, LeNet/VGG's 2x2/2, Inception's
# 3x3/1 pad 1, a ceil-mode odd size, ragged channel counts, and the kernel's
# other branches: a 5x3 window with unequal pads and a 1x1/2 (the loops), a
# 16x16 window (int32 offsets), and a view whose storage spans 2^31 elements
# or more (64-bit indices), at the stem's window and at the loops'.  "ints":
# integer values in [-4, 4], so windows hold exact ties; "relu": max(N(0,
# 1), 0), half of it an exact 0; "wide": ints in a strided view of a 2^31 +
# N*H*W*C element buffer.
POOL_CASES = [
    ("stem_nhwc_f32", (256, 64, 112, 112), 3, 2, 1, False, "NHWC",
     torch.float32, "ints"),
    ("stem_nhwc_bf16", (256, 64, 112, 112), 3, 2, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("stem_nchw_f32", (256, 64, 112, 112), 3, 2, 1, False, "NCHW",
     torch.float32, "ints"),
    ("stem_nhwc_bf16_relu", (256, 64, 112, 112), 3, 2, 1, False, "NHWC",
     torch.bfloat16, "relu"),
    ("2x2s2_nchw_f32", (32, 64, 56, 56), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("3x3s1p1_nhwc_bf16", (32, 192, 28, 28), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("3x3s2_ceil_odd_nhwc_f32", (8, 64, 27, 27), 3, 2, 0, True, "NHWC",
     torch.float32, "ints"),
    ("3x3s2p1_c3_nhwc_f32", (8, 3, 33, 33), 3, 2, 1, False, "NHWC",
     torch.float32, "ints"),
    ("3x3s2p1_c160_nhwc_bf16", (8, 160, 14, 14), 3, 2, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("5x3s2p2x1_nhwc_f32", (8, 64, 29, 30), (5, 3), 2, (2, 1), False, "NHWC",
     torch.float32, "ints"),
    ("5x3s2p2x1_nchw_bf16", (8, 64, 29, 30), (5, 3), 2, (2, 1), False,
     "NCHW", torch.bfloat16, "ints"),
    ("1x1s2_nhwc_bf16", (8, 64, 28, 28), 1, 2, 0, False, "NHWC",
     torch.bfloat16, "ints"),
    ("16x16s8_nhwc_f32", (4, 64, 64, 64), 16, 8, 0, False, "NHWC",
     torch.float32, "ints"),
    ("16x16s8_ceil_nchw_bf16", (4, 32, 61, 61), 16, 8, 0, True, "NCHW",
     torch.bfloat16, "ints"),
    ("3x3s2p1_wide_nhwc_bf16", (2, 64, 28, 28), 3, 2, 1, False, "NHWC",
     torch.bfloat16, "wide"),
    ("5x3s2p2x1_wide_nhwc_bf16", (2, 64, 28, 28), (5, 3), 2, (2, 1), False,
     "NHWC", torch.bfloat16, "wide"),
    # LeNet-5's two pools at batch 128 (NCHW f32, two_pass)
    ("lenet_pool1_nchw_f32", (128, 6, 24, 24), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("lenet_pool2_nchw_f32", (128, 12, 8, 8), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    # the same two pools at batch 64, a process's batch in the world-2
    # DistriOptimizer check
    ("lenet_b64_pool1_nchw_f32", (64, 6, 24, 24), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("lenet_b64_pool2_nchw_f32", (64, 12, 8, 8), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    # VGG for CIFAR-10's five 2x2/2 pools at batch 128 (NCHW f32, two_pass)
    ("vgg_pool1_nchw_f32", (128, 64, 32, 32), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("vgg_pool2_nchw_f32", (128, 128, 16, 16), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("vgg_pool3_nchw_f32", (128, 256, 8, 8), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("vgg_pool4_nchw_f32", (128, 512, 4, 4), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    ("vgg_pool5_nchw_f32", (128, 512, 2, 2), 2, 2, 0, False, "NCHW",
     torch.float32, "ints"),
    # Inception v1's 13 pools at batch 256 (NHWC bf16, tiled_nhwc), its 10
    # distinct geometries: four 3x3/2 ceil-mode pools (the stem's two,
    # pool3, pool4) and the towers' 3x3/1 pad 1 (4b-4d and 5a-5b share one)
    ("inception_pool1_nhwc_bf16", (256, 64, 112, 112), 3, 2, 0, True,
     "NHWC", torch.bfloat16, "ints"),
    ("inception_pool2_nhwc_bf16", (256, 192, 56, 56), 3, 2, 0, True,
     "NHWC", torch.bfloat16, "ints"),
    ("inception_3a_nhwc_bf16", (256, 192, 28, 28), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_3b_nhwc_bf16", (256, 256, 28, 28), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_pool3_nhwc_bf16", (256, 480, 28, 28), 3, 2, 0, True,
     "NHWC", torch.bfloat16, "ints"),
    ("inception_4a_nhwc_bf16", (256, 480, 14, 14), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_4b_nhwc_bf16", (256, 512, 14, 14), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_4e_nhwc_bf16", (256, 528, 14, 14), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    ("inception_pool4_nhwc_bf16", (256, 832, 14, 14), 3, 2, 0, True,
     "NHWC", torch.bfloat16, "ints"),
    ("inception_5a_nhwc_bf16", (256, 832, 7, 7), 3, 1, 1, False, "NHWC",
     torch.bfloat16, "ints"),
    # the card-vs-CPU check's Inception v1 (NCHW f32, batch 4, two_pass):
    # a 3x3/2 ceil-mode pool, and 3x3/1 pad 1 pools whose overlapping
    # windows add into one input element, at 28x28 and at the 7x7 edge
    ("inception_check_pool1_nchw_f32", (4, 64, 112, 112), 3, 2, 0, True,
     "NCHW", torch.float32, "ints"),
    ("inception_check_3a_nchw_f32", (4, 192, 28, 28), 3, 1, 1, False,
     "NCHW", torch.float32, "ints"),
    ("inception_check_5a_nchw_f32", (4, 832, 7, 7), 3, 1, 1, False, "NCHW",
     torch.float32, "ints"),
]
LENET_POOL_CASES = ("lenet_pool1_nchw_f32", "lenet_pool2_nchw_f32")
DISTRI_POOL_CASES = ("lenet_b64_pool1_nchw_f32", "lenet_b64_pool2_nchw_f32")
VGG_POOL_CASES = tuple(f"vgg_pool{i}_nchw_f32" for i in range(1, 6))
INCEPTION_POOL_CASES = tuple(c[0] for c in POOL_CASES
                             if c[0].startswith("inception_"))
# the cases that take B1's tiled_nhwc variant: NHWC, C a whole number of
# 16-byte vectors, 16-byte-aligned bases, 32-bit offsets and windows of
# fewer than 255 positions; the others (NCHW, C=3, the 16x16 windows, the
# 2^31-element views) take two_pass
TILED_CASES = {"stem_nhwc_f32", "stem_nhwc_bf16", "stem_nhwc_bf16_relu",
               "3x3s1p1_nhwc_bf16", "3x3s2_ceil_odd_nhwc_f32",
               "3x3s2p1_c160_nhwc_bf16", "5x3s2p2x1_nhwc_f32",
               "1x1s2_nhwc_bf16",
               *(c for c in INCEPTION_POOL_CASES if c.endswith("_nhwc_bf16"))}


def pair(v):
    return tuple(v) if isinstance(v, tuple) else (v, v)


def pool_operands(shape, k, s, p, ceil, fmt, dtype, kind, gen, device):
    """x (NCHW-indexed; for NHWC the channels_last view of an NHWC tensor),
    its pool output y, a gradient g, the pads, the kernel and the stride,
    for one case."""
    N, C, H, W = shape
    (kh, kw), (sh, sw), (ph, pw) = pair(k), pair(s), pair(p)
    dims = (N, H, W, C) if fmt == "NHWC" else shape
    if kind == "relu":
        x = torch.relu(torch.randn(dims, generator=gen, device=device))
    elif kind == "tanh":
        x = torch.tanh(torch.randn(dims, generator=gen, device=device))
    else:
        x = torch.randint(-4, 5, dims, generator=gen, device=device).float()
    x = x.to(dtype)
    if kind == "wide":  # sample n at n * 2^31 // (N - 1) of a wide buffer
        step = -(-2 ** 31 // (N - 1))
        buf = torch.empty(step * (N - 1) + x[0].numel(), dtype=dtype,
                          device=device)
        wide = buf.as_strided(dims, (step,) + x.stride()[1:])
        wide.copy_(x)
        x = wide
    if fmt == "NHWC":
        x = x.permute(0, 3, 1, 2)
    pads = nn.SpatialMaxPooling(kw, kh, sw, sh, pw, ph,
                                ceil_mode=ceil)._pads((H, W))
    with torch.no_grad():
        y = maxpool.maxpool2d(x, (kh, kw), (sh, sw), pads)
    g = torch.randn(y.shape, generator=gen, device=device).to(dtype)
    if fmt == "NHWC":
        g = g.contiguous(memory_format=torch.channels_last)
    return x, y, g, pads, (kh, kw), (sh, sw)


def kernel_pass(name):
    """B1's kernel (a variant's, or a pass of two_pass) that a profiled
    kernel name belongs to."""
    return next((p for p in ("maxpool_bwd_tiled", "first_match",
                             "scatter_first") if p in name), name[:40])


def pool_bound(shape, y_shape, dtype):
    """(least ms, "bytes"): x, y and g read once, gi written once, at the
    card's memory rate; about one comparison per covered position, far
    below the card's rate for them."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = es * (2 * int(np.prod(shape)) + 2 * int(np.prod(y_shape)))
    return nbytes / HBM_BPS * 1e3, "bytes", nbytes


def pool_case_check(case, gen, device):
    """B1 against its plain version at one case of POOL_CASES, bitwise,
    in the variant TILED_CASES names."""
    name, shape, k, s, p, ceil, fmt, dtype, kind = case
    x, y, g, pads, k, s = pool_operands(shape, k, s, p, ceil, fmt, dtype,
                                        kind, gen, device)
    got = maxpool.launch(x, y, g, k, s, pads)
    variant = maxpool.last_variant
    want_variant = "tiled_nhwc" if name in TILED_CASES else "two_pass"
    if variant[0] != want_variant:
        raise AssertionError(f"B1 {name}: took {variant}, want "
                             f"{want_variant}")
    want = maxpool.maxpool_bwd_reference(x, y, g, k, s, pads)
    torch.cuda.synchronize()
    # a view that is not dense gets a dense gradient (empty_like's rule)
    layout = torch.empty_like(x).stride()
    if not torch.equal(got, want) or got.stride() != layout:
        err = (got.float() - want.float()).abs().max().item()
        raise AssertionError(f"B1 {name}: not bitwise equal to its plain "
                             f"version (max abs err {err}, strides "
                             f"{got.stride()} vs {layout})")
    ties = (y == 0).float().mean().item() if kind == "relu" else None
    print(f"pool check {name}: x {tuple(x.shape)} strides {x.stride()} "
          f"{fmt} {dtype} kernel {k} stride {s} pads {pads}: "
          f"{variant[0]} (tile of {variant[1]}, vectors {variant[2]}, "
          f"blocks {variant[3]}) bitwise equal"
          + (f" (windows with an all-zero max: {ties:.3f})"
             if ties is not None else ""))
    del x, y, g, got, want
    torch.cuda.empty_cache()


def pool_kernel_phase(device, card, report):
    """B1 against its plain version at every case of POOL_CASES but VGG's
    and Inception's (their phases check those), bitwise (both add the
    same terms in the same order and dtype), each in the variant that
    TILED_CASES names, then, at the ResNet-50 stem (NHWC, batch 256) in
    bf16 (the training path's type) and f32: kernel, plain and library
    times beside the bound."""
    gen = torch.Generator(device=device).manual_seed(2718)
    for case in POOL_CASES:
        if case[0] not in VGG_POOL_CASES + INCEPTION_POOL_CASES:
            pool_case_check(case, gen, device)
    rows = {name: pool_row(pool_case(name), gen, device, card)
            for name in ("stem_nhwc_bf16", "stem_nhwc_f32")}
    report["pool_kernel"] = rows
    return rows["stem_nhwc_bf16"]


def pool_case(name):
    return next(c for c in POOL_CASES if c[0] == name)


def pool_row(case, gen, device, card):
    """B1 at one case of POOL_CASES on post-ReLU inputs (what every pool
    of the main paths sees): bitwise against its plain version
    on the timed inputs, in the variant TILED_CASES names, within rounding
    of the library's ``max_pool2d_with_indices_backward``, then kernel,
    plain and library times beside the bound."""
    name, shape, k, s, p, ceil, fmt, dtype = case[:8]
    x, y, g, pads, kk, ss = pool_operands(shape, k, s, p, ceil, fmt,
                                          dtype, "relu", gen, device)
    # the library's own first-match pair: indices from the forward,
    # then the backward that scatters through them
    kl, sl, pl = list(kk), list(ss), list(pair(p))
    _, ind = torch.nn.functional.max_pool2d(x, kl, sl, pl, ceil_mode=ceil,
                                            return_indices=True)
    geo = (kk, ss, pads)
    fns = (lambda: maxpool.launch(x, y, g, *geo),
           lambda: maxpool.maxpool_bwd_reference(x, y, g, *geo),
           lambda: torch.ops.aten.max_pool2d_with_indices_backward(
               g, x, kl, sl, pl, [1, 1], ceil, ind))
    # the timed inputs too: bitwise against the plain version
    got, want = fns[0](), fns[1]()
    variant = maxpool.last_variant
    want_variant = "tiled_nhwc" if name in TILED_CASES else "two_pass"
    if variant[0] != want_variant:
        raise AssertionError(f"B1 {name}: took {variant}, want "
                             f"{want_variant}")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.equal(got, want):
        raise AssertionError(f"B1 {name} on the timed inputs: max abs "
                             f"err {err} against its plain version")
    # the same function: the library sums a position's (at most n)
    # window gradients in f32 in another order and rounds once, B1
    # rounds to x's dtype after each add: they agree within one ulp of
    # a partial sum (at most n max|g|) for each of the n adds
    lib = fns[2]()
    n = -(-kk[0] // ss[0]) * -(-kk[1] // ss[1])
    ulp = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(lib.float(), got.float(), rtol=0,
                               atol=n * n * ulp * g.abs().max().item())
    del got, want
    passes = []
    k_ev, p_ev, l_ev = (cuda_ms(f, budget_ms=100.0) for f in fns)
    k_ms = device_ms(fns[0], calls=20, split=passes)
    l_ms = device_ms(fns[2], calls=20)
    b_ms, b_by, nbytes = pool_bound(shape, y.shape, dtype)
    row = {"ms": k_ms, "plain_ms": p_ev, "library_ms": l_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "max_abs_err": err, "event_ms": k_ev, "library_event_ms": l_ev,
           "library_call": "aten.max_pool2d_with_indices_backward "
                           "(indices from max_pool2d)",
           "passes": passes, "variant": list(variant)}
    print(f"maxpool_bwd {name} x {tuple(x.shape)} {fmt} {dtype} kernel "
          f"{kk} stride {ss} pads {pads}: {variant[0]} (tile of "
          f"{variant[1]}, vectors {variant[2]}, blocks {variant[3]}): "
          f"max_abs_err={err} "
          f"against the plain version; device ms per call (torch.profiler) "
          f"kernel_ms={k_ms:.4f} library_ms={l_ms:.4f}; event-timed "
          f"kernel {k_ev:.4f} plain {p_ev:.4f} library {l_ev:.4f}; "
          f"bound_ms={b_ms:.4f} ({b_by}: {nbytes / 1e9:.3f} GB at "
          f"{HBM_BPS / 1e12:.2f} TB/s); by kernel: "
          + ", ".join(f"{kernel_pass(n)} {ms:.4f}" for n, ms in passes)
          + f" [{card}]")
    del x, y, g, ind, lib
    return row


# ------------------------------------------------------ ResNet-50 training
# the ImageNet recipe (examples/resnet/train_imagenet.py) on one card:
# NHWC, bf16 compute, batch 256, SGD momentum 0.9 / dampening 0 / weight
# decay 1e-4 with EpochDecayWithWarmUp (5 warm-up epochs, /10 at 30/60/80),
# max_lr scaled linearly from its batch-8192 3.2 to 0.1 at batch 256, K=4.
# The recipe's synthetic stand-in images, 1024 of them (4 steps an epoch, so
# a K=4 block is an epoch).
RESNET = {"batch": 256, "K": 4, "size": 224, "classes": 1000,
          "samples": 1024, "workers": 8, "timed_blocks": 3, "max_lr": 0.1,
          "warmup_epochs": 5, "check_batch": 8, "check_steps": 2}
# the card against the CPU (grad_reading: the losses and the first step's
# per-layer gradients; unit_reading: each conv+BN unit's per-layer
# gradients): above the sound readings, below the three planted faults
# that every run measures and requires to exceed it
RESNET_TRAIN_TOL = 1e-3


def recipe_samples(n, size, classes, seed=0):
    """The recipe's synthetic stand-in (train_imagenet.py:80-88): uint8 HWC
    images, a class-coloured patch on noise."""
    rng = np.random.default_rng(seed)
    samples = []
    for y in rng.integers(0, classes, n):
        img = rng.integers(0, 60, (size, size, 3)).astype(np.uint8)
        r, c = divmod(int(y) % 16, 4)
        q = size // 4
        img[r * q:(r + 1) * q, c * q:(c + 1) * q, int(y) % 3] += 150
        samples.append(Sample(img, np.int32(y)))
    return samples


_RESNET_DATA = {}


def resnet_data():
    """(samples, their pre-augmented Samples) of the recipe at
    RESNET["samples"] images, made once."""
    if not _RESNET_DATA:
        B, size = RESNET["batch"], RESNET["size"]
        samples = recipe_samples(RESNET["samples"], size, RESNET["classes"])
        t0 = time.monotonic()
        _RESNET_DATA["samples"] = samples
        _RESNET_DATA["augmented"] = pre_augmented(samples, B, size)
        print(f"pre-augmented {len(samples)} samples in "
              f"{time.monotonic() - t0:.1f} s (8 workers)")
    return _RESNET_DATA["samples"], _RESNET_DATA["augmented"]


def recipe_augment(size):
    """The recipe's per-sample augmentation, NHWC."""
    aug = (V.RandomAlterAspect(target_size=size) >> V.HFlip()
           >> V.ChannelNormalize((123.68, 116.78, 103.94),
                                 (58.4, 57.1, 57.4))
           >> V.ImageFrameToSample(to_chw=False))
    return lambda s: aug(V.ImageFeature(s.feature, s.label))["sample"]


def pre_augmented(samples, batch, size):
    """The recipe's pipeline run once over ``samples``: the augmented
    Samples, in order."""
    out = []
    it = (DataSet.array(samples) >> MTSampleToMiniBatch(
        batch, recipe_augment(size), workers=RESNET["workers"])).data(
            train=False)
    for b in it:
        out += [Sample(f, t) for f, t in zip(b.input, b.target)]
    return out


class RecordingSGD(optim.SGD):
    """SGD that keeps a float64 CPU copy of every step's gradients."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.grads = []

    def update(self, grads, params, state, lr, step):
        self.grads.append({k: g.detach().double().cpu()
                           for k, g in grads.items()})
        super().update(grads, params, state, lr, step)


def recipe_sgd(iters_per_epoch, cls=optim.SGD):
    warm = RESNET["warmup_epochs"] * iters_per_epoch
    max_lr = RESNET["max_lr"]
    base_lr = max_lr / warm
    return cls(learning_rate=base_lr, momentum=0.9, dampening=0.0,
               weight_decay=1e-4,
               learning_rate_schedule=optim.EpochDecayWithWarmUp(
                   warm, (max_lr - base_lr) / warm,
                   lambda e: sum(1 for d in (30, 60, 80) if e >= d)))


def resnet_train(model, dataset, device, steps, k, compute, iters_per_epoch,
                 sgd=None):
    """Train ``model`` in place through LocalOptimizer with the recipe's
    SGD (or ``sgd``); (per-step losses, per-step host clock at replay,
    optimizer, wall seconds)."""
    losses, clock = [], []

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

    opt = (Recording(model, dataset, nn.ClassNLLCriterion(), device=device)
           .set_optim_method(sgd or recipe_sgd(iters_per_epoch))
           .set_compute_dtype(compute)
           .set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(steps)))
    t0 = time.monotonic()
    opt.optimize()
    return losses, clock, opt, time.monotonic() - t0


def planted_b1_fault():
    """A wrapper of B1 whose first launch returns its result x127/128."""
    sound = maxpool.launch
    calls = [0]

    def launch(*args):
        calls[0] += 1
        gi = sound(*args)
        return gi * (127 / 128) if calls[0] == 1 else gi
    return launch


def zero_init_residual(model):
    """``model`` with the last BatchNorm's gamma of every residual block's
    main path at 0 (the large-batch ImageNet recipe's init, Goyal et al.
    2017): each block starts as its shortcut."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConcatTable):
                main = m[0]
                main[len(main) - 1][1].weight.zero_()
    return model


def unit_grads(unit, a, seed, device, fault=None):
    """One conv+BatchNorm unit's gradients (parameters, and ``input``) on
    ``device`` for the input ``a`` and a seeded N(0, 1) gradient at its
    output; ``fault`` edits the unit's copy first."""
    u = copy.deepcopy(unit).to(device).train()
    if fault is not None:
        fault(u)
    params = dict(u.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    a = a.to(device, copy=True).requires_grad_(True)
    out = u(a)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    (out * g.to(device)).sum().backward()
    grads = {k: p.grad.double().cpu() for k, p in params.items()}
    grads["input.x"] = a.grad.double().cpu()
    return grads


def layer_shares(got, ref, prefix=""):
    """Per layer (parameters grouped by module), the largest difference of
    ``got`` from ``ref`` as a share of the layer's largest value in ``ref``
    (a layer that is all zero in ``ref`` must be all zero in ``got``):
    [(share, layer)]."""
    layers = {}
    for k in ref:
        layers.setdefault(k.rsplit(".", 1)[0], []).append(k)
    rows = []
    for layer, keys in layers.items():
        scale = max(ref[k].abs().max().item() for k in keys)
        diff = max((got[k] - ref[k]).abs().max().item() for k in keys)
        rows.append((diff / scale if scale > 0 else
                     (0.0 if diff == 0 else float("inf")), prefix + layer))
    return rows


def unit_reading(model, x, device):
    """Every conv+BatchNorm unit of ``model`` (53 in ResNet-50: the stem,
    3 a block, 4 shortcuts; f32, training mode) on the card against the
    CPU, each from its input in the CPU's forward of ``x`` and a seeded
    gradient at its output: (largest share, its four largest (share,
    layer), the planted fault's reading).  No ReLU lies inside a unit, so
    rounding cannot flip a mask between the devices.  The fault is block
    8's 3x3 conv weight x127/128 on the card (the BatchNorm after it
    cancels the scale in the forward; the weight's gradient grows by
    128/127)."""
    net = copy.deepcopy(model).train()
    units = {name: m for name, m in net.named_modules()
             if isinstance(m, nn.Sequential) and len(m) == 2
             and isinstance(m[0], nn.SpatialConvolution)
             and isinstance(m[1], nn.SpatialBatchNormalization)}
    inputs = {}
    for name, m in units.items():
        m.register_forward_pre_hook(
            lambda mod, args, name=name: inputs.__setitem__(name, args[0]))
    with torch.no_grad():
        net(x)
    rows, fault = [], None
    for seed, (name, unit) in enumerate(units.items()):
        unit = copy.deepcopy(unit)
        unit._forward_pre_hooks.clear()
        want = unit_grads(unit, inputs[name], seed, "cpu")
        rows += layer_shares(unit_grads(unit, inputs[name], seed, device),
                             want, f"{name}.")
        if name == "8.0.0.2":
            fault = max(layer_shares(unit_grads(
                unit, inputs[name], seed, device,
                lambda u: u[0].weight.data.mul_(127 / 128)), want,
                f"{name}."))
    rows.sort(reverse=True)
    return rows[0][0], rows[:4], fault, len(units)


def resnet_check_phase(seed, device, card, report):
    """ResNet-50 (224x224, 1000 classes, NHWC, f32) on the card against the
    CPU, in two readings, each against RESNET_TRAIN_TOL with planted faults
    that must read above it:

    - the path: RESNET["check_steps"] steps of batch 8 in one block through
      LocalOptimizer, from the same seeded weights and the same augmented
      batches, residual gammas at 0 (:func:`grad_reading`); faults: the
      stem conv's weight x127/128 and B1's first result x127/128;
    - every conv+BatchNorm unit at the model's own init (gammas 1), each
      from its input in the CPU's forward of the first batch
      (:func:`unit_reading`); fault: block 8's 3x3 conv weight x127/128.

    Why two: whole-model f32 gradients of this model at batch 8 are
    ill-conditioned whenever gradient reaches the blocks' inner layers:
    the card and the CPU then differ by percents of a layer's largest
    gradient, as much as the CPU differs from itself when a batch's samples
    are reversed (``--phases resnet-conditioning`` measures both).  At
    gamma 0 the path is well conditioned, but the inner layers get no
    gradient at the first step and a fault there reads nothing; the unit
    reading holds them, one conv and its BatchNorm at a time.  (Whole
    blocks are ill-conditioned too: a ReLU whose input lies within
    rounding of 0 on one device and not the other sends a different
    gradient through that position.)"""
    B, steps = RESNET["check_batch"], RESNET["check_steps"]
    data = pre_augmented(recipe_samples(B * steps, RESNET["size"],
                                        RESNET["classes"], seed),
                         B, RESNET["size"])
    plain = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    init = zero_init_residual(copy.deepcopy(plain))

    def run(dev, model=None):
        sgd = recipe_sgd(steps, RecordingSGD)
        losses = resnet_train(model or copy.deepcopy(init),
                              DataSet.array(data) >> SampleToMiniBatch(B),
                              dev, steps, steps, None, steps, sgd)[0]
        return losses, sgd.grads

    t0 = time.monotonic()
    want = run("cpu")
    cpu_s = time.monotonic() - t0
    maxpool.launches = 0
    got = run(device)
    if maxpool.launches != steps:
        raise AssertionError(f"B1 launched {maxpool.launches} times in "
                             f"{steps} steps")
    sound, worst, later = grad_reading(got, want)
    faults, fault_worst = {}, {}
    m = copy.deepcopy(init)
    with torch.no_grad():
        m[0][0].weight.mul_(127 / 128)  # the stem conv
    faults["stem_weight_127_128"], fault_worst["stem_weight_127_128"], _ = \
        grad_reading(run(device, m), want)
    sound_launch = maxpool.launch
    maxpool.launch = planted_b1_fault()
    try:
        faults["b1_one_step_127_128"], fault_worst["b1_one_step_127_128"], \
            _ = grad_reading(run(device), want)
    finally:
        maxpool.launch = sound_launch

    x = torch.from_numpy(np.stack([s.feature for s in data[:B]]))
    units, units_worst, unit_fault, n_units = unit_reading(plain, x, device)
    faults["block8_conv2_weight_127_128"] = unit_fault[0]
    fault_worst["block8_conv2_weight_127_128"] = [unit_fault]
    print(f"resnet50 train-vs-cpu largest shares (share, layer): path "
          f"{worst}, later steps (not gated) {later}; units "
          f"{units_worst}; "
          + "; ".join(f"{k} {v}" for k, v in fault_worst.items()))
    print(f"resnet50 train-vs-cpu check, NHWC f32: path ({steps} steps of "
          f"batch {B} in one block, residual gammas at 0) {sound:.3e}, "
          f"conv+BN units ({n_units}, gammas 1, batch {B}) {units:.3e}, "
          f"planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {RESNET_TRAIN_TOL}); cpu losses "
          + ", ".join(f"{v:.6f}" for v in want[0]) + "; card losses "
          + ", ".join(f"{v:.6f}" for v in got[0])
          + f"; the CPU's block took {cpu_s:.1f} s [{card}]")
    report["resnet_check"] = {"sound": sound, "largest": worst,
                              "later_steps": later, "units": units,
                              "units_largest": units_worst,
                              "planted_faults": faults,
                              "planted_largest": fault_worst,
                              "tol": RESNET_TRAIN_TOL,
                              "cpu_losses": want[0], "card_losses": got[0]}
    for name, err in (("training", sound), ("conv+BN units", units)):
        if not err <= RESNET_TRAIN_TOL:
            raise AssertionError(f"ResNet-50 on the card ({name}) is "
                                 f"{err:.3e} from the CPU, over the limit "
                                 f"{RESNET_TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > RESNET_TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the ResNet-50 "
                f"training tolerance {RESNET_TRAIN_TOL}: the check is blind")


def resnet_conditioning_phase(seed, device, card, report):
    """Why the check phase holds the conv+BN units one at a time (not run by
    default): the path reading (:func:`grad_reading`) of its K=2 block at
    residual gammas 0, 0.001, 0.1 and 1, card against CPU, beside the
    CPU's own reading of the same steps with each batch's samples in
    reverse order (the same sums in another order)."""
    B, steps = RESNET["check_batch"], RESNET["check_steps"]
    data = pre_augmented(recipe_samples(B * steps, RESNET["size"],
                                        RESNET["classes"], seed),
                         B, RESNET["size"])
    rev = [s for i in range(0, len(data), B) for s in data[i:i + B][::-1]]
    plain = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    out = {}
    for gamma in (0.0, 0.001, 0.1, 1.0):
        init = copy.deepcopy(plain)
        with torch.no_grad():
            for m in init.modules():
                if isinstance(m, nn.ConcatTable):
                    m[0][len(m[0]) - 1][1].weight.fill_(gamma)

        def run(dev, d):
            sgd = recipe_sgd(steps, RecordingSGD)
            losses = resnet_train(copy.deepcopy(init), DataSet.array(d)
                                  >> SampleToMiniBatch(B), dev, steps, steps,
                                  None, steps, sgd)[0]
            return losses, sgd.grads
        want = run("cpu", data)
        card_r = grad_reading(run(device, data), want)
        cpu_r = grad_reading(run("cpu", rev), want)
        out[gamma] = {"card": card_r[:2], "cpu_reversed": cpu_r[:2]}
        print(f"resnet50 conditioning, residual gammas {gamma}: card vs cpu "
              f"{card_r[0]:.3e} {card_r[1][:2]}; cpu on reversed batches vs "
              f"cpu {cpu_r[0]:.3e} {cpu_r[1][:2]} [{card}]")
    report["resnet_conditioning"] = out


def grad_reading(run, want):
    """How far a training run ``(losses, per-step gradients)`` is from the
    CPU's: the larger of the relative loss difference over the steps and,
    per layer, the largest difference of the first step's gradients as a
    share of the layer's largest gradient on the CPU (a layer whose CPU
    gradient is all zero must be all zero on the card too).  Returns the
    reading, its four largest (share, layer) and, not gated, the largest
    share of each later step.

    Per layer, not per array: a BatchNorm bias's gradient sums the gradient
    at the layer's output over N*H*W positions, a sum that nearly cancels,
    and is held to the scale of the weight's gradient, which sums the same
    terms times x_hat.  First step only: later steps start from weights
    that already differ in their last bits, and their gradients depend on
    them ill-conditionedly, so those steps are held by their losses."""
    (losses, grads), (want_losses, want_grads) = run, want
    rows = [(abs(a - b) / abs(b), f"step {j} loss")
            for j, (a, b) in enumerate(zip(losses, want_losses))]
    rows += layer_shares(grads[0], want_grads[0])
    later = [max(layer_shares(g, w))
             for g, w in zip(grads[1:], want_grads[1:])]
    rows.sort(reverse=True)
    return rows[0][0], rows[:4], later


def resnet_profile_step(init, batch, device, card):
    """One bf16 step of the recipe (forward, backward, SGD update) under
    torch.profiler after a warm-up step: wall ms, device busy ms, idle share,
    kernel launches and the top device operations."""
    net = copy.deepcopy(init).to(device).train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    sgd = recipe_sgd(RESNET["samples"] // RESNET["batch"])
    ostate = sgd.init_state(params)
    loss_fn = mixed_precision_loss_fn(net, nn.ClassNLLCriterion(),
                                      torch.bfloat16)
    x = torch.from_numpy(np.stack([s.feature for s in batch])).to(device)
    y = torch.from_numpy(np.stack([s.label for s in batch])).to(device)

    def step():
        for p in params.values():
            p.grad = None
        loss_fn(params, x, y).backward()
        sgd.update({k: p.grad for k, p in params.items()}, params, ostate,
                   0.01, 0)

    return profile_step(step, f"resnet50 train step (bf16, batch "
                        f"{len(batch)})", card, 8)


def resnet_timed_phase(seed, device, card, report):
    """The recipe on the card, timed twice: through its own pipeline
    (MTSampleToMiniBatch, 8 workers) and over batches augmented beforehand.
    Each run: a warm-up block then RESNET["timed_blocks"] K=4 blocks;
    images/s and ms per step from the host clock at which each block's
    losses came back; per-block loss (finite, falling); peak memory; B1's
    launches (one a step).  Then one profiled step."""
    B, K, size = RESNET["batch"], RESNET["K"], RESNET["size"]
    steps = K * (1 + RESNET["timed_blocks"])
    per_epoch = RESNET["samples"] // B
    samples, augmented = resnet_data()
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    datasets = {
        "pipeline": lambda: DataSet.array(samples) >> MTSampleToMiniBatch(
            B, recipe_augment(size), workers=RESNET["workers"]),
        "pre_augmented": lambda: DataSet.array(augmented)
        >> SampleToMiniBatch(B)}
    out, launches = {}, {}
    sound_launch = maxpool.launch
    for name, make in datasets.items():
        t0 = time.monotonic()
        model = copy.deepcopy(init)
        torch.cuda.reset_peak_memory_stats()
        maxpool.reset_counts()
        dtypes = []  # of every B1 launch: the stem's activation is bf16

        def launch(x, *a):
            dtypes.append(x.dtype)
            return sound_launch(x, *a)
        maxpool.launch = launch
        try:
            losses, clock, opt, wall = resnet_train(
                model, make(), device, steps, K, torch.bfloat16, per_epoch)
        finally:
            maxpool.launch = sound_launch
        launches[name] = maxpool.launches
        peak = torch.cuda.max_memory_allocated()
        if launches[name] != steps or opt.state["neval"] != steps:
            raise AssertionError(f"{name}: B1 launched {launches[name]} "
                                 f"times in {opt.state['neval']} steps")
        if set(dtypes) != {torch.bfloat16}:
            raise AssertionError(f"{name}: B1 ran on {set(dtypes)}, not on "
                                 f"the bf16 compute dtype")
        if maxpool.variant_launches["tiled_nhwc"] != steps:
            raise AssertionError(f"{name}: B1 variants "
                                 f"{maxpool.variant_launches}, want "
                                 f"{steps} tiled_nhwc")
        blocks = [float(np.mean(losses[i:i + K]))
                  for i in range(0, steps, K)]
        if not (np.all(np.isfinite(losses)) and blocks[-1] < blocks[0]):
            raise AssertionError(f"{name}: the loss is not finite and "
                                 f"falling: {blocks}")
        # block b's losses come back after block b+1 is enqueued: the
        # clock at the last step of each block marks that block's end
        ends = [clock[i + K - 1] for i in range(0, steps, K)]
        step_s = (ends[-1] - ends[0]) / (steps - K)
        out[name] = {"ms_per_step": step_s * 1e3,
                     "images_per_s": B / step_s, "block_losses": blocks,
                     "losses": losses, "max_memory_allocated": peak,
                     "launches": launches[name], "wall_s": wall,
                     "epoch": opt.state["epoch"]}
        print(f"train resnet50 {name} NHWC bf16 batch {B} K={K}: {steps} "
              f"steps, the {RESNET['timed_blocks']} blocks after the first: "
              f"ms_per_step={step_s * 1e3:.2f} images_per_s={B / step_s:.1f} "
              f"max_memory_allocated={peak} block losses "
              + ", ".join(f"{v:.4f}" for v in blocks)
              + f"; B1 launches {launches[name]} for {steps} steps, all "
              f"bf16 tiled_nhwc; "
              f"final: epoch={opt.state['epoch']} "
              f"loss={opt.state['loss']:.4f}; run {time.monotonic() - t0:.1f} "
              f"s [{card}]")
        del model, opt
        torch.cuda.empty_cache()
    out["profile"] = resnet_profile_step(init, augmented[:B], device, card)
    report["resnet_train"] = out
    return launches["pipeline"]


# ------------------------------------------------------- Wide&Deep, B3
BAG_KERNEL = {"route": "cuda", "source": "bigdl_tpu_torch/csrc/embed_bag.cu",
              "replaces": "bigdl_tpu/ops/pallas_embed.py:151"}
# the census Wide&Deep of bench.py's _wide_deep_measure: wide table
# 100,000 x 1, deep fields 10000/1000/100/100/50 at embed 16, 13 dense
# features, MLP (100, 50), batch 8192 with 8 wide ids a sample (nnz 65,536),
# f32; K=8 (bench.py PRODUCTION_K["wide_deep"]); Adam at lr 0.01, the
# recipe's --sparse-coo optimizer (examples/recommender/train_wide_deep.py)
WD = {"wide": 100_000, "fields": (10_000, 1_000, 100, 100, 50), "embed": 16,
      "dense": 13, "hidden": (100, 50), "batch": 8192, "nnz_per": 8, "K": 8,
      "lr": 0.01, "timed_blocks": 3}
# (name, N, V, D, nnz, table dtype, values dtype, layout): the census wide
# path, D 16, 128 and a ragged 129, unsorted rows with duplicates, empty
# rows and the padding tail, bf16 table and values, a single row, a table
# of 2^31 elements or more (64-bit offsets; its table gradient groups 2^24+1
# keys, more than one window of the fine pass a bucket), and every entry on
# one key in both roles.  "census": 8 ids a sample in row order; "unsorted":
# rows drawn at random from 90% of the rows, then an nnz/16 padding tail of
# (0, 0, 0.0); "one_key": every row 0, every col one value.
BAG_CASES = [
    ("census", 8192, 100_000, 1, 65_536, torch.float32, torch.float32,
     "census"),
    ("d16", 2048, 50_000, 16, 16_384, torch.float32, torch.float32,
     "unsorted"),
    ("d128", 1024, 20_000, 128, 8192, torch.float32, torch.float32,
     "unsorted"),
    ("d129_ragged", 1000, 5000, 129, 8000, torch.float32, torch.float32,
     "unsorted"),
    ("unsorted_pad_d1", 8192, 100_000, 1, 65_536, torch.float32,
     torch.float32, "unsorted"),
    ("bf16", 4096, 30_000, 16, 32_768, torch.bfloat16, torch.bfloat16,
     "unsorted"),
    ("bf16_table_f32_values", 4096, 30_000, 16, 32_768, torch.bfloat16,
     torch.float32, "unsorted"),
    ("single_row", 1, 1000, 8, 64, torch.float32, torch.float32, "unsorted"),
    ("offsets_64bit", 64, 2 ** 24 + 1, 128, 4096, torch.bfloat16,
     torch.bfloat16, "unsorted"),
    ("one_key", 8192, 100_000, 1, 65_536, torch.float32, torch.float32,
     "one_key"),
]
# B3's grouping passes alone (not the bag walk: these keys would index the
# table or g out of range) against row_index (check_grouping): (name, nnz,
# n_keys, low, high) with keys uniform in [low, high), so some lie below 0
# and at or above n_keys; then the stream's first entries set to int32's
# extremes.
# The census shapes of both roles, keys all below 0, all above, an empty
# stream, a stream of chunks of 23 tiles (above 1024 x 128 entries), and
# keys over all of int32 into 2^27 keys (1024 windows of the fine pass a
# bucket).
GROUP_EDGE_CASES = [
    ("census_rows_out_of_range", 65_536, 8192, -3000, 8192 + 3000),
    ("census_cols_out_of_range", 65_536, 100_000, -5000, 105_000),
    ("all_below_0", 4096, 1000, -2 ** 31, 0),
    ("all_at_or_above_n_keys", 4096, 1000, 1000, 2 ** 31),
    ("empty_stream", 0, 1000, 0, 1000),
    ("multi_tile_chunks", 3_000_000, 100_000, -10, 100_010),
    ("int32_range", 65_536, 2 ** 27, -2 ** 31, 2 ** 31),
]
# the kernels of one B3 call, each from csrc/embed_bag.cu: the grouping
# passes 1-3, then the bag walk
BAG_PASSES = ("bag_hist", "bag_coarse", "bag_fine", "bag_walk")
# the card's K=8 block against the CPU (wd_step_reading): above the sound
# reading and below the three planted faults that every run measures and
# requires to exceed it
WD_TRAIN_TOL = 3e-5


def bag_operands(case, gen, device):
    """rows, cols, values, table and an output gradient g for one case."""
    _, N, V, D, nnz, tdtype, vdtype, layout = case
    if layout == "census":
        rows = torch.arange(N, device=device, dtype=torch.int32) \
            .repeat_interleave(nnz // N)
        cols = torch.randint(0, V, (nnz,), generator=gen, device=device,
                             dtype=torch.int32)
        vals = torch.ones(nnz, device=device)
    elif layout == "one_key":
        rows = torch.zeros(nnz, device=device, dtype=torch.int32)
        cols = torch.randint(0, V, (1,), generator=gen, device=device,
                             dtype=torch.int32).expand(nnz).contiguous()
        vals = torch.randn(nnz, generator=gen, device=device)
    else:
        pad = nnz // 16
        live = torch.nonzero(torch.rand(N, generator=gen, device=device)
                             > 0.1).flatten() if N > 1 else \
            torch.zeros(1, dtype=torch.long, device=device)
        pick = torch.randint(0, live.numel(), (nnz - pad,), generator=gen,
                             device=device)
        z = torch.zeros(pad, dtype=torch.int32, device=device)
        rows = torch.cat([live[pick].to(torch.int32), z])
        lo = V - 4096 if V > 2 ** 24 else 0  # reach the table's far end
        cols = torch.cat([torch.randint(lo, V, (nnz - pad,), generator=gen,
                                        device=device, dtype=torch.int32), z])
        vals = torch.cat([torch.randn(nnz - pad, generator=gen,
                                      device=device),
                          torch.zeros(pad, device=device)])
    table = torch.empty((V, D), dtype=tdtype, device=device)
    table.normal_(generator=gen)
    g = torch.randn((N, D), generator=gen, device=device)
    return rows, cols, vals.to(vdtype), table, g


def bag_bound(rows, cols, table, out_rows, out_dtype):
    """(least ms, "bytes" | "operations", bytes): rows, cols and values
    read once, the table rows this stream names read once, the output
    written once, at the card's memory rate; one FMA (2 operations) per
    entry and column at the f32 rate."""
    D, es = table.shape[1], table.element_size()
    n_rows_read = int(torch.unique(cols).numel())
    out_es = torch.tensor([], dtype=out_dtype).element_size()
    nbytes = 12 * rows.numel() + n_rows_read * D * es + out_rows * D * out_es
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = 2.0 * rows.numel() * D / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations", nbytes


def library_bag(rows, cols, vals, table, n_rows):
    """One PyTorch call for the same bag sum, over the row-sorted stream:
    ``F.embedding_bag(..., mode="sum", per_sample_weights=...)`` (a
    yardstick; the port never calls it)."""
    perm, offsets = embed_bag.row_index(rows, n_rows)
    idx, w = cols[perm].long(), vals[perm].to(table.dtype)
    starts = offsets[:-1].contiguous()
    return lambda: torch.nn.functional.embedding_bag(
        idx, table, starts, mode="sum", per_sample_weights=w)


def library_route(rows, cols, vals, table, n_rows):
    """The whole call on library calls from the unsorted stream: a stable
    ``torch.sort``, ``searchsorted``, the gathers and ``F.embedding_bag``
    (a yardstick; the port never calls it)."""
    def run():
        perm, offsets = embed_bag.row_index(rows, n_rows)
        return torch.nn.functional.embedding_bag(
            cols[perm].long(), table, offsets[:-1], mode="sum",
            per_sample_weights=vals[perm].to(table.dtype))
    return run


def check_grouping(keys, n_keys, what):
    """B3's grouping passes against row_index, bitwise, in the plan's
    index dtype: offsets in full, perm over [offsets[0], offsets[n_keys])
    (what the bag walk reads); before it the entries with keys below 0 and
    after it those at or above n_keys, each in nnz order (row_index orders
    these by key)."""
    perm, offsets = embed_bag.group_index(keys, n_keys)
    want_perm, want_offsets = embed_bag.row_index(keys, n_keys)
    dtype = embed_bag.group_plan(keys.numel(), n_keys).index_dtype
    torch.cuda.synchronize()
    if perm.dtype != dtype or offsets.dtype != dtype:
        raise AssertionError(f"B3 grouping {what}: {perm.dtype} / "
                             f"{offsets.dtype}, want {dtype}")
    if not torch.equal(offsets.long(), want_offsets):
        bad = torch.nonzero(offsets.long() != want_offsets)[:5].flatten()
        raise AssertionError(f"B3 grouping {what}: offsets differ from "
                             f"row_index's first at {bad.tolist()}")
    lo, hi = int(want_offsets[0]), int(want_offsets[-1])
    k = keys.long()
    for part, got, want in (
            ("below 0", perm[:lo], torch.nonzero(k < 0).flatten()),
            ("in range", perm[lo:hi], want_perm[lo:hi]),
            ("at or above n_keys", perm[hi:],
             torch.nonzero(k >= n_keys).flatten())):
        if not torch.equal(got.long(), want):
            raise AssertionError(f"B3 grouping {what}: perm's entries {part} "
                                 f"differ from the stream's")


def grouping_split(keys, n_keys, card):
    """Device ms of B3's grouping passes alone on ``keys`` into ``n_keys``,
    split by pass: at 2^24+1 keys each of the fine pass's 129 buckets walks
    its 2^17 keys in 1024-key windows and writes that many offsets."""
    split = []
    ms = device_ms(lambda: embed_bag.group_index(keys, n_keys), calls=10,
                   split=split)
    by_pass = {p: sum(t for name, t in split if p in name)
               for p in BAG_PASSES[:3]}
    plan = embed_bag.group_plan(keys.numel(), n_keys)
    print(f"bag grouping alone nnz={keys.numel()} n_keys={n_keys} "
          f"({plan.buckets} buckets, shift {plan.shift}: "
          f"{-(-(1 << plan.shift) // 1024)} windows a bucket): device ms "
          f"{ms:.5f} (" + ", ".join(f"{p} {t:.5f}" for p, t in by_pass.items())
          + f") [{card}]")
    return {"n_keys": n_keys, "nnz": keys.numel(), "ms": ms,
            "split": by_pass}


def group_edge_keys(nnz, low, high, gen, device):
    keys = torch.randint(low, high, (nnz,), generator=gen, device=device,
                         dtype=torch.int64)
    keys[:4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, -1, 0])[:nnz]
    return keys.clamp(low, high - 1).to(torch.int32)


def bag_kernel_phase(device, card, report):
    """B3 against its plain version, bitwise, at every case of BAG_CASES,
    forward and the swapped-role weight gradient, with its grouping passes'
    (perm, offsets) bitwise against row_index in both roles; the grouping
    alone at GROUP_EDGE_CASES, and timed by pass at the widest key range
    (offsets_64bit's 2^24+1 keys); then at the census shape, for the forward
    and for the weight gradient: one call with host syncs made errors, the
    call's device time split by kernel (each one of BAG_PASSES), an
    event-timed loop of the whole wrapper, the plain version, the library
    route (sort, searchsorted, ``F.embedding_bag``) and ``F.embedding_bag``
    alone on the pre-sorted stream, beside the bound."""
    gen = torch.Generator(device=device).manual_seed(3141)
    err, wide_keys = 0.0, None
    for case in BAG_CASES:
        name, N, V = case[:3]
        rows, cols, vals, table, g = bag_operands(case, gen, device)
        check_grouping(rows, N, f"{name} forward")
        check_grouping(cols, V, f"{name} table gradient")
        got = embed_bag.launch(rows, cols, vals, table, N)
        want = embed_bag.embedding_bag_coo_reference(rows, cols, vals, table,
                                                     N)
        got_t = embed_bag.launch(cols, rows, vals, g, V)
        want_t = embed_bag.embedding_bag_coo_reference(cols, rows, vals, g, V)
        torch.cuda.synchronize()
        same = [torch.equal(got, want), torch.equal(got_t, want_t)]
        # the difference only where they differ: the 64-bit case's table
        # gradient alone is 8.6 GB
        errs = [0.0 if eq else (a.float() - b.float()).abs().max().item()
                for eq, (a, b) in zip(same, ((got, want), (got_t, want_t)))]
        err = max([err] + errs)
        if not all(same):
            raise AssertionError(f"B3 {name}: not bitwise equal to its "
                                 f"plain version (max abs err forward "
                                 f"{errs[0]}, table gradient {errs[1]})")
        if got.dtype != torch.result_type(table, vals):
            raise AssertionError(f"B3 {name}: output dtype {got.dtype}")
        empty = N - int(torch.unique(rows).numel())
        print(f"bag check {name}: N={N} V={V} D={table.shape[1]} nnz="
              f"{rows.numel()} table {table.dtype} values {vals.dtype}, "
              f"{empty} empty rows: grouping (perm, offsets) of both roles "
              f"equal to row_index's, forward and table gradient bitwise "
              f"equal")
        if V > 2 ** 24:  # the widest key range: the fine pass's windows
            wide_keys = grouping_split(cols, V, card)
        del rows, cols, vals, table, g, got, want, got_t, want_t
        torch.cuda.empty_cache()
    for name, nnz, n_keys, low, high in GROUP_EDGE_CASES:
        keys = group_edge_keys(nnz, low, high, gen, device)
        check_grouping(keys, n_keys, name)
        plan = embed_bag.group_plan(nnz, n_keys)
        outside = int(((keys < 0) | (keys >= n_keys)).sum())
        print(f"bag grouping check {name}: nnz={nnz} n_keys={n_keys}, "
              f"{outside} keys outside [0, n_keys): perm and offsets equal "
              f"to row_index's ({plan.buckets} buckets, shift "
              f"{plan.shift}, chunk {plan.chunk})")
        del keys

    rows, cols, vals, table, g = bag_operands(BAG_CASES[0], gen, device)
    N, V = BAG_CASES[0][1:3]
    out = {}
    for role, args, n_out in (("forward", (rows, cols, vals, table, N), N),
                              ("table_grad", (cols, rows, vals, g, V), V)):
        r, c, v, t, n = args
        fns = (lambda: embed_bag.launch(*args),
               lambda: embed_bag.embedding_bag_coo_reference(*args),
               library_bag(r, c, v, t, n), library_route(r, c, v, t, n))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync would raise
        try:
            got = fns[0]()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want, lib, route = (f() for f in fns[1:])
        e = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"B3 {role} on the timed inputs: max abs "
                                 f"err {e} against its plain version")
        # the library sums each bag in its own order: within rounding
        for y in (lib, route):
            torch.testing.assert_close(y.float(), got.float(), rtol=1e-5,
                                       atol=1e-5 * got.abs().max().item())
        err = max(err, e)
        split = []
        k_ms = device_ms(fns[0], calls=50, split=split)
        by_pass = {p: sum(ms for name, ms in split if p in name)
                   for p in BAG_PASSES}
        foreign = [name for name, _ in split
                   if not any(p in name for p in BAG_PASSES)]
        if foreign or not all(by_pass.values()):
            raise AssertionError(f"B3 {role}: a call launched {foreign} "
                                 f"beside csrc/embed_bag.cu's kernels, or "
                                 f"not each of {BAG_PASSES}: {split}")
        l_ms, route_ms = (device_ms(f, calls=50) for f in fns[2:])
        k_ev, p_ev, l_ev, route_ev = (cuda_ms(f) for f in fns)
        b_ms, b_by, nbytes = bag_bound(r, c, t, n_out, got.dtype)
        out[role] = {"ms": k_ms, "split": by_pass,
                     "group_ms": k_ms - by_pass["bag_walk"],
                     "event_ms": k_ev, "plain_ms": p_ev, "library_ms": l_ms,
                     "library_event_ms": l_ev, "library_route_ms": route_ms,
                     "library_route_event_ms": route_ev, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "max_abs_err": e,
                     "plan": embed_bag.group_plan(r.numel(), n)._asdict()}
        print(f"embed_bag {role} N={n_out} nnz={r.numel()} D={t.shape[1]}: "
              f"device ms per call, whole call kernel_ms={k_ms:.5f} ("
              + ", ".join(f"{p} {ms:.5f}" for p, ms in by_pass.items())
              + f"; only csrc/embed_bag.cu's kernels, no host sync) "
              f"library_ms={l_ms:.5f} [F.embedding_bag, pre-sorted] "
              f"library_route_ms={route_ms:.5f} [sort + searchsorted + "
              f"F.embedding_bag]; event-timed wrapper {k_ev:.5f} plain "
              f"{p_ev:.5f} library {l_ev:.5f} route {route_ev:.5f}; "
              f"bound_ms={b_ms:.6f} ({b_by}: {nbytes} B at "
              f"{HBM_BPS / 1e12:.2f} TB/s) [{card}]")
        del got, want, lib, route
    out["wide_keys_grouping"] = wide_keys
    report["bag_kernel"] = out
    row = dict(out["forward"])
    row["max_abs_err"] = err
    return row


def wd_model(seed):
    return WideAndDeep(WD["wide"], list(WD["fields"]), WD["dense"],
                       WD["embed"], WD["hidden"]).initialize(seed)


def wd_data(n, seed):
    """n census-shaped records as numpy columns: 8 wide ids a record with
    value 1, one id per deep field, 13 N(0, 1) dense features, and a
    label from a planted teacher: the sign of the sum of an N(0, 1) weight
    per wide id and per field-0 id, so that the loss can fall."""
    rng = np.random.default_rng(seed)
    k = WD["nnz_per"]
    wide = rng.integers(0, WD["wide"], (n, k)).astype(np.int32)
    deep = np.stack([rng.integers(0, c, n) for c in WD["fields"]],
                    axis=1).astype(np.int32)
    dense = rng.normal(0, 1, (n, WD["dense"])).astype(np.float32)
    w_wide = rng.normal(0, 1, WD["wide"])
    w_f0 = rng.normal(0, 1, WD["fields"][0])
    logit = w_wide[wide].sum(1) / np.sqrt(k) + w_f0[deep[:, 0]]
    return wide, deep, dense, (logit > 0).astype(np.float32)


def wd_samples(cols):
    """The records as the recipe's SparseSamples."""
    wide, deep, dense, y = cols
    ones = np.ones(WD["nnz_per"], np.float32)
    return [SparseSample(wide[i], ones, WD["wide"], dense=[deep[i], dense[i]],
                         label=y[i]) for i in range(len(y))]


def wd_batches(cols):
    """The records as SparseMiniBatches of WD["batch"], built from the
    columns (the same arrays batch_sparse_samples gives)."""
    wide, deep, dense, y = cols
    B, k = WD["batch"], WD["nnz_per"]
    row = np.repeat(np.arange(B, dtype=np.int32), k)
    ones = torch.ones(B * k)
    out = []
    for s in range(0, len(y) - B + 1, B):
        coo = nn.COOBatch(torch.from_numpy(row),
                          torch.from_numpy(wide[s:s + B].reshape(-1)), ones,
                          (B, WD["wide"]))
        out.append(SparseMiniBatch((coo, deep[s:s + B], dense[s:s + B]),
                                   y[s:s + B]))
    return out


class SparseToMiniBatch(Transformer):
    """The recipe's feed: SparseSamples in batches of WD["batch"] through
    batch_sparse_samples at the census nnz."""

    def __call__(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == WD["batch"]:
                yield batch_sparse_samples(buf, [WD["batch"] * WD["nnz_per"]])
                buf = []


class Prebuilt(Transformer):
    """Batches built beforehand, in turn, one for every WD["batch"]
    records the dataset yields (the records themselves are not read)."""

    def __init__(self, batches):
        self.batches = batches

    def __call__(self, it):
        for i in itertools.count():
            for _ in range(WD["batch"]):
                next(it)
            yield self.batches[i % len(self.batches)]


class SqueezedBCE:
    """BCE on the (N, 1) score's column (bench.py's _SqueezeBCE)."""

    def __init__(self):
        self.bce = nn.BCECriterion()

    def apply(self, out, y):
        return self.bce.apply(out[:, 0], y)


def wd_train(model, dataset, device, steps, method=None):
    """Train ``model`` in place through LocalOptimizer with the recipe's
    Adam (or ``method``) in K=8 blocks: (per-step losses, per-step host
    clock at replay, optimizer, wall seconds)."""
    losses, clock = [], []

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

    opt = (Recording(model, dataset, SqueezedBCE(), device=device)
           .set_optim_method(method or optim.Adam(learning_rate=WD["lr"]))
           .set_steps_per_dispatch(WD["K"])
           .set_end_when(optim.max_iteration(steps)))
    t0 = time.monotonic()
    opt.optimize()
    return losses, clock, opt, time.monotonic() - t0


def planted_bag_fault(role, step):
    """A wrapper of B3's launch that scales its result by 127/128 at one
    training step: the forward's (``role="forward"``, the launch over the
    batch's rows) or the table gradient's (``"table_grad"``, the launch
    over the wide table's rows)."""
    sound = embed_bag.launch
    calls = {"forward": 0, "table_grad": 0}

    def launch(rows, cols, values, table, n_rows):
        out = sound(rows, cols, values, table, n_rows)
        kind = "forward" if n_rows == WD["batch"] else "table_grad"
        calls[kind] += 1
        return out * (127 / 128) if kind == role and calls[kind] == step + 1 \
            else out
    return launch


WD_FAULT_STEP = 3  # of the K=8 block's steps 0..7


def recording(cls):
    """``cls`` (an optimization method) keeping float64 CPU copies of every
    step's parameters (as the step found them) and gradients in
    ``steps``."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.steps = []

        def update(self, grads, params, state, lr, step):
            self.steps.append(({k: p.detach().double().cpu()
                                for k, p in params.items()},
                               {k: g.detach().double().cpu()
                                for k, g in grads.items()}))
            super().update(grads, params, state, lr, step)
    return Recording


RecordingAdam = recording(optim.Adam)


def wd_cpu_step(init, params, batch):
    """The loss and the gradients of one training step on the CPU (the
    plain versions), from ``params`` on ``batch``."""
    m = copy.deepcopy(init)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
            p.requires_grad_(True)
    coo, deep, dense = batch.input
    loss = SqueezedBCE().apply(
        m((coo, torch.from_numpy(deep), torch.from_numpy(dense))),
        torch.from_numpy(batch.target))
    loss.backward()
    return loss.item(), {k: p.grad.double() for k, p in m.named_parameters()}


def max_share(got, want):
    """The largest difference as a share of ``want``'s largest value."""
    return ((got - want).abs().max() / want.abs().max()).item()


def norm_share(got, want):
    """``||got - want|| / ||want||``."""
    return (got - want).norm().item() / max(want.norm().item(), 1e-300)


def wd_step_reading(losses, steps, init, batches, cpu_step=wd_cpu_step,
                    share=max_share):
    """How far a K-step card run is from the CPU, step by step: the weights
    the card started from against ``init`` (per array, the largest
    difference as a share of its largest value), and for each step j the
    relative difference of its loss and, per array, of its gradient (as a
    share of the array's largest gradient on the CPU; Inception's check
    passes ``norm_share``) from the same step on the CPU from the card's
    own weights of step j.  (reading, its four largest (share, what)).
    Per array, not per layer as in :func:`grad_reading`: no gradient here
    is a sum that nearly cancels (the sound readings of the card runs are
    a few 1e-7), and the wide weight's own gradient is held apart from
    the bias's.

    Step by step, not over the trained weights (the PTB check's reading,
    :func:`train_reading`, printed beside it): Adam moves each weight by
    about lr times the sign of its gradient, so a gradient within rounding
    of 0 on one device moves the other way on the other, and the trained
    weights of two sound runs differ by a share of training's change that
    swings from run to run with the signs that flip.  ``cpu_step`` redoes
    one step on the CPU (LeNet's check passes its own)."""
    start = flat_params(init)
    rows = [(max_share(steps[0][0][k], w), f"start {k}")
            for k, w in start.items()]
    for j, (params, grads) in enumerate(steps):
        loss, want = cpu_step(init, params, batches[j])
        rows.append((abs(losses[j] - loss) / abs(loss), f"step {j} loss"))
        rows += [(share(grads[k], w), f"step {j} {k}")
                 for k, w in want.items()]
    rows.sort(reverse=True)
    return rows[0][0], rows[:4]


def wd_check_phase(seed, device, card, report):
    """One K=8 block at the census dims on the card through LocalOptimizer
    against the CPU, step by step (:func:`wd_step_reading`), from the same
    port init and the same batches; and three planted faults on the card
    that must read above WD_TRAIN_TOL: the wide weight x127/128 at init,
    B3's forward result x127/128 at step WD_FAULT_STEP, and B3's table
    gradient x127/128 at that step.  The PTB check's reading of the trained
    weights (:func:`train_reading`) against a whole CPU run is printed
    beside it, not gated."""
    K, B = WD["K"], WD["batch"]
    batches = wd_batches(wd_data(K * B, seed + 1))
    init = wd_model(seed)

    def dataset():
        return DataSet.array(np.zeros(K * B)) >> Prebuilt(batches)

    def card_run(model, fault=None):
        adam = RecordingAdam(learning_rate=WD["lr"])
        sound_launch = embed_bag.launch
        if fault is not None:
            embed_bag.launch = planted_bag_fault(fault, WD_FAULT_STEP)
        try:
            losses = wd_train(model, dataset(), device, K, adam)[0]
        finally:
            embed_bag.launch = sound_launch
        return losses, adam.steps

    t0 = time.monotonic()
    cpu_model = copy.deepcopy(init)
    cpu_losses = wd_train(cpu_model, dataset(), "cpu", K)[0]
    cpu_s = time.monotonic() - t0
    card_model = copy.deepcopy(init)
    embed_bag.launches = 0
    card_losses, card_steps = card_run(card_model)
    if embed_bag.launches != 2 * K:
        raise AssertionError(f"B3 launched {embed_bag.launches} times in "
                             f"{K} steps (want 2 a step)")
    sound, worst = wd_step_reading(card_losses, card_steps, init, batches)
    weights_reading = train_reading(card_losses, card_model, cpu_losses,
                                    flat_params(cpu_model), flat_params(init))
    faults, fault_worst = {}, {}
    m = copy.deepcopy(init)
    with torch.no_grad():
        m.wide.weight.mul_(127 / 128)
    runs = {"wide_weight_127_128": (m, None)}
    for role in ("forward", "table_grad"):
        runs[f"b3_{role}_step{WD_FAULT_STEP}_127_128"] = (
            copy.deepcopy(init), role)
    for name, (m, role) in runs.items():
        faults[name], fault_worst[name] = wd_step_reading(
            *card_run(m, role), init, batches)
    print(f"wide-deep train-vs-cpu largest shares (share, what): sound "
          f"{worst}; " + "; ".join(f"{k} {v}" for k, v in
                                   fault_worst.items()))
    print(f"wide-deep train-vs-cpu check, {K} steps of batch {B} step by "
          f"step: sound {sound:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {WD_TRAIN_TOL}); trained weights against a whole CPU "
          f"run (train_reading, not gated) {weights_reading:.3e}; cpu "
          f"losses " + ", ".join(f"{v:.6f}" for v in cpu_losses)
          + "; card losses " + ", ".join(f"{v:.6f}" for v in card_losses)
          + f"; the CPU's block took {cpu_s:.1f} s [{card}]")
    report["wide_deep_check"] = {"sound": sound, "largest": worst,
                                 "planted_faults": faults,
                                 "planted_largest": fault_worst,
                                 "weights_reading": weights_reading,
                                 "tol": WD_TRAIN_TOL,
                                 "cpu_losses": cpu_losses,
                                 "card_losses": card_losses}
    if not sound <= WD_TRAIN_TOL:
        raise AssertionError(f"Wide&Deep training on the card is "
                             f"{sound:.3e} from the CPU, over the limit "
                             f"{WD_TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > WD_TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the "
                f"Wide&Deep training tolerance {WD_TRAIN_TOL}: the check is "
                f"blind")


def wd_profile_step(init, batch, device, card):
    """One training step (forward, backward, Adam update) of the census
    Wide&Deep under torch.profiler after a warm-up step."""
    net = copy.deepcopy(init).to(device).train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    adam = optim.Adam(learning_rate=WD["lr"])
    ostate = adam.init_state(params)
    coo, deep, dense = batch.input
    x = (coo.to(device), torch.from_numpy(deep).to(device),
         torch.from_numpy(dense).to(device))
    y = torch.from_numpy(batch.target).to(device)
    crit = SqueezedBCE()

    def step():
        for p in params.values():
            p.grad = None
        crit.apply(net(x), y).backward()
        adam.update({k: p.grad for k, p in params.items()}, params, ostate,
                    WD["lr"], 0)

    return profile_step(step, f"wide-deep train step (f32, batch "
                        f"{WD['batch']})", card, 8)


def wd_timed_phase(seed, device, card, report):
    """The census Wide&Deep on the card, timed twice: through the recipe's
    feed (SparseSamples >> SparseToMiniBatch, batch_sparse_samples in
    Python) and over batches built beforehand.  Each run: a warm-up block
    then WD["timed_blocks"] K=8 blocks; records/s and ms per step from the
    host clock at which each block's losses came back; B3's launches (2 a
    step); peak memory; block losses that must be finite and fall.  Then
    one profiled step."""
    K, B = WD["K"], WD["batch"]
    steps = K * (1 + WD["timed_blocks"])
    t0 = time.monotonic()
    cols = wd_data(steps * B, seed)
    samples = wd_samples(cols)
    batches = wd_batches(cols)
    print(f"wide-deep data: {len(samples)} records as SparseSamples and "
          f"{len(batches)} batches in {time.monotonic() - t0:.1f} s")
    init = wd_model(seed)
    datasets = {
        "recipe_feed": lambda: DataSet.array(samples) >> SparseToMiniBatch(),
        "prebuilt": lambda: DataSet.array(samples) >> Prebuilt(batches)}
    out, launches = {}, {}
    for name, make in datasets.items():
        t0 = time.monotonic()
        model = copy.deepcopy(init)
        torch.cuda.reset_peak_memory_stats()
        embed_bag.launches = 0
        losses, clock, opt, wall = wd_train(model, make(), device, steps)
        launches[name] = embed_bag.launches
        peak = torch.cuda.max_memory_allocated()
        if launches[name] != 2 * steps or opt.state["neval"] != steps:
            raise AssertionError(f"{name}: B3 launched {launches[name]} "
                                 f"times in {opt.state['neval']} steps "
                                 f"(want 2 a step)")
        blocks = [float(np.mean(losses[i:i + K]))
                  for i in range(0, steps, K)]
        if not (np.all(np.isfinite(losses)) and blocks[-1] < blocks[0]):
            raise AssertionError(f"{name}: the loss is not finite and "
                                 f"falling: {blocks}")
        ends = [clock[i + K - 1] for i in range(0, steps, K)]
        step_s = (ends[-1] - ends[0]) / (steps - K)
        out[name] = {"ms_per_step": step_s * 1e3,
                     "records_per_s": B / step_s, "block_losses": blocks,
                     "losses": losses, "max_memory_allocated": peak,
                     "launches": launches[name], "wall_s": wall}
        print(f"train wide-deep {name} f32 batch {B} K={K}: {steps} steps, "
              f"the {WD['timed_blocks']} blocks after the first: "
              f"ms_per_step={step_s * 1e3:.3f} records_per_s="
              f"{B / step_s:.1f} max_memory_allocated={peak} block losses "
              + ", ".join(f"{v:.4f}" for v in blocks)
              + f"; B3 launches {launches[name]} for {steps} steps; run "
              f"{time.monotonic() - t0:.1f} s [{card}]")
        del model, opt
    out["profile"] = wd_profile_step(init, batches[0], device, card)
    report["wide_deep_train"] = out
    return launches["recipe_feed"]


# ---------------------------------------------------------------- LeNet-5
# examples/lenet/train.py on one card: LeNet-5 (NCHW f32, its two 2x2/2
# pools' backward on B1's two_pass variant) on synthetic MNIST at MNIST's
# own counts (60,000 training images, 10,000 validation images: a ragged
# last validation batch of 16), batch 128, the recipe's SGD (lr 0.05,
# momentum 0.9, no decay), K from Engine.steps_per_dispatch(), two epochs,
# Top-1/Top-5 every epoch, a snapshot every epoch, both summaries.
LENET = {"train": 60_000, "val": 10_000, "batch": 128, "lr": 0.05,
         "momentum": 0.9, "epochs": 2, "warmup_steps": 20, "check_K": 4,
         "resume_iters": 160, "resume_every": 50, "preempt_at": 120,
         "min_top1": 0.9}
# the card against the CPU, step by step (wd_step_reading) and on the
# validation log-probabilities: above the sound readings, below the two
# planted faults every run measures and requires to exceed it
LENET_TRAIN_TOL = 1e-3
_LENET_DATA = {}


def lenet_data():
    """(train, validation) (images, labels) of synthetic_mnist, made once."""
    if not _LENET_DATA:
        _LENET_DATA["train"] = mnist.synthetic_mnist(LENET["train"], seed=0)
        _LENET_DATA["val"] = mnist.synthetic_mnist(LENET["val"], seed=99)
    return _LENET_DATA["train"], _LENET_DATA["val"]


def lenet_pipeline(data, train, n=None, batch=None, distributed=False):
    """The recipe's pipeline over the first ``n`` images of ``data``:
    to_samples >> BytesToGreyImg >> GreyImgNormalizer >>
    SampleToMiniBatch(128, or ``batch``), the last batch kept for
    validation; ``distributed``: this process's shard."""
    imgs, labels = data
    mean, std = (mnist.TRAIN_MEAN, mnist.TRAIN_STD) if train \
        else (mnist.TEST_MEAN, mnist.TEST_STD)
    return (DataSet.array(mnist.to_samples(imgs[:n], labels[:n]),
                          distributed=distributed)
            >> image.BytesToGreyImg() >> image.GreyImgNormalizer(mean, std)
            >> SampleToMiniBatch(batch or LENET["batch"],
                                 drop_remainder=train))


def lenet_sgd(cls=optim.SGD):
    return cls(learning_rate=LENET["lr"], learning_rate_decay=0.0,
               momentum=LENET["momentum"])


def lenet_pool_phase(device, card, report):
    """B1 at LeNet's two pools: bitwise against its plain version on
    integer inputs (ties) in two_pass, then on tanh outputs its device
    time beside the bound, the plain version and the library's
    ``max_pool2d_with_indices_backward``."""
    gen = torch.Generator(device=device).manual_seed(3141)
    rows = {}
    for name in LENET_POOL_CASES:
        case = next(c for c in POOL_CASES if c[0] == name)
        pool_case_check(case, gen, device)
        shape, k, s, p, ceil, fmt, dtype = case[1:8]
        x, y, g, pads, kk, ss = pool_operands(shape, k, s, p, ceil, fmt,
                                              dtype, "tanh", gen, device)
        _, ind = torch.nn.functional.max_pool2d(x, k, s, p,
                                                return_indices=True)
        geo = (kk, ss, pads)
        fns = (lambda: maxpool.launch(x, y, g, *geo),
               lambda: maxpool.maxpool_bwd_reference(x, y, g, *geo),
               lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                   g, x, [k, k], [s, s], [p, p], [1, 1], False, ind))
        got, want = fns[0](), fns[1]()
        variant = maxpool.last_variant
        if variant[0] != "two_pass":
            raise AssertionError(f"B1 {name}: took {variant}")
        err = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"B1 {name} on the timed inputs: max abs "
                                 f"err {err} against its plain version")
        # no window overlaps another: each position takes at most one
        # gradient, so the library's gi is B1's unless a window ties
        lib = fns[2]()
        torch.testing.assert_close(lib, got, rtol=0, atol=0)
        passes = []
        k_ms = device_ms(fns[0], calls=50, split=passes)
        l_ms = device_ms(fns[2], calls=50)
        k_ev, p_ev, l_ev = (cuda_ms(f, budget_ms=50.0) for f in fns)
        b_ms, b_by, nbytes = pool_bound(shape, y.shape, dtype)
        rows[name] = {"ms": k_ms, "plain_ms": p_ev, "library_ms": l_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                      "max_abs_err": err, "event_ms": k_ev,
                      "library_event_ms": l_ev, "passes": passes,
                      "variant": list(variant)}
        print(f"maxpool_bwd {name} x {tuple(x.shape)} {variant[0]} "
              f"(blocks {variant[3]}): max_abs_err={err} against the plain "
              f"version, library equal; device ms per call kernel_ms="
              f"{k_ms:.5f} library_ms={l_ms:.5f}; event-timed kernel "
              f"{k_ev:.5f} plain {p_ev:.5f} library {l_ev:.5f}; bound_ms="
              f"{b_ms:.5f} ({b_by}: {nbytes / 1e6:.3f} MB at "
              f"{HBM_BPS / 1e12:.2f} TB/s); by kernel: "
              + ", ".join(f"{kernel_pass(n)} {ms:.5f}" for n, ms in passes)
              + f" [{card}]")
        del x, y, g, ind, got, want, lib
    report["lenet_pool"] = rows
    return rows


def lenet_profile_step(init, batch, device, card):
    """One training step (forward, backward, SGD update) of LeNet-5 at
    batch 128 under torch.profiler after a warm-up step."""
    net = copy.deepcopy(init).to(device).train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    sgd = lenet_sgd()
    ostate = sgd.init_state(params)
    x = torch.from_numpy(batch.input).to(device)
    y = torch.from_numpy(batch.target).to(device)
    crit = nn.ClassNLLCriterion()

    def step():
        for p in params.values():
            p.grad = None
        crit.apply(net(x), y).backward()
        sgd.update({k: p.grad for k, p in params.items()}, params, ostate,
                   LENET["lr"], 0)

    return profile_step(step, f"lenet train step (f32, batch "
                        f"{LENET['batch']})", card, 8)


def timed_commits(sound):
    """A wrapper of the checkpoint manager's writer ``sound`` that records
    (file, commit ms, bytes on disk) of each snapshot it commits."""
    commits = []

    def write(path, **kw):
        t0 = time.perf_counter()
        out = sound(path, **kw)
        commits.append((os.path.basename(path),
                        (time.perf_counter() - t0) * 1e3,
                        os.path.getsize(path)))
        return out
    return write, commits


def lenet_timed_phase(seed, device, card, report):
    """The LeNet recipe on the card: two epochs of synthetic MNIST through
    LocalOptimizer with validation, snapshots and both summaries.  Prints
    samples/s and ms a step (host clock at replay, epoch 1 after its first
    steps, validation and snapshots left out), peak memory, Top-1/Top-5
    after each epoch, each snapshot's commit ms and bytes; fails unless
    Top-1 after the last epoch exceeds LENET["min_top1"], the loss falls
    and B1 launched 2 a step, all two_pass (validation runs the forward
    only).  Then one profiled step."""
    t0 = time.monotonic()
    train, val = lenet_data()
    print(f"lenet data: synthetic_mnist {len(train[1])} training and "
          f"{len(val[1])} validation images in {time.monotonic() - t0:.1f} s")
    init = lenet5(10).initialize(seed)
    model = copy.deepcopy(init)
    losses, clock, scores = [], [], []

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

        def _run_validation(self, run):
            t = time.perf_counter()
            res = super()._run_validation(run)
            if res is not None:
                scores.append({"neval": self.state["neval"],
                               "top1": res["Top1Accuracy"].result,
                               "top5": res["Top5Accuracy"].result,
                               "count": res["Top1Accuracy"].count,
                               "s": time.perf_counter() - t})
            return res

    sound_write = ckpt_manager.write_snapshot
    write, commits = timed_commits(sound_write)
    K = Engine.steps_per_dispatch()
    with tempfile.TemporaryDirectory() as tmp:
        opt = (Recording(model, lenet_pipeline(train, True),
                         nn.ClassNLLCriterion(), device=device)
               .set_optim_method(lenet_sgd())
               .set_end_when(optim.max_epoch(LENET["epochs"]))
               .set_validation(optim.every_epoch(),
                               lenet_pipeline(val, False),
                               [optim.Top1Accuracy(), optim.Top5Accuracy()])
               .set_checkpoint(tmp, optim.every_epoch())
               .set_train_summary(TrainSummary(tmp, "lenet"))
               .set_val_summary(ValidationSummary(tmp, "lenet")))
        torch.cuda.reset_peak_memory_stats()
        maxpool.reset_counts()
        ckpt_manager.write_snapshot = write
        t1 = time.monotonic()
        try:
            opt.optimize()
        finally:
            ckpt_manager.write_snapshot = sound_write
        wall = time.monotonic() - t1
        peak = torch.cuda.max_memory_allocated()
        opt.train_summary.close()
        opt.validation_summary.close()
        events = {phase: sum(os.path.getsize(os.path.join(d, f))
                             for d, _, fs in os.walk(os.path.join(
                                 tmp, "lenet", phase)) for f in fs)
                  for phase in ("train", "validation")}
        stall = opt.registry.histogram("checkpoint/driver_stall_s").snapshot()
    steps = opt.state["neval"]
    launches = maxpool.launches
    per_epoch = -(-LENET["train"] // LENET["batch"])
    if steps != LENET["epochs"] * per_epoch or launches != 2 * steps \
            or maxpool.variant_launches["two_pass"] != launches:
        raise AssertionError(f"lenet: {steps} steps, B1 launched {launches} "
                             f"times ({maxpool.variant_launches}); want "
                             f"{LENET['epochs'] * per_epoch} steps, 2 "
                             f"two_pass launches a step")
    w = LENET["warmup_steps"]
    step_s = (clock[per_epoch - 1] - clock[w]) / (per_epoch - 1 - w)
    first, last = np.mean(losses[:w]), np.mean(losses[-w:])
    print(f"train lenet f32 batch {LENET['batch']} K={K}: {steps} steps in "
          f"{LENET['epochs']} epochs, {wall:.2f} s with validation and "
          f"snapshots; epoch 1's steps {w}..{per_epoch - 1}: ms_per_step="
          f"{step_s * 1e3:.3f} samples_per_s={LENET['batch'] / step_s:.1f}"
          f" max_memory_allocated={peak}; mean loss of the first / last "
          f"{w} steps {first:.4f} / {last:.4f}; B1 launches {launches} "
          f"({maxpool.variant_launches}) [{card}]")
    for s in scores:
        print(f"lenet validation after iteration {s['neval']}: Top1Accuracy="
              f"{s['top1']:.4f} Top5Accuracy={s['top5']:.4f} over "
              f"{int(s['count'])} images in {s['s'] * 1e3:.1f} ms [{card}]")
    for name, ms, nbytes in commits:
        print(f"lenet snapshot {name}: commit_ms={ms:.2f} bytes={nbytes} "
              f"(the writer thread: serialize, CRC32-C, fsync, rename)")
    print(f"lenet checkpoint driver stall per save (copy to the host and "
          f"enqueue): {stall}; event files {events} bytes")
    if len(scores) != LENET["epochs"] or len(commits) != LENET["epochs"]:
        raise AssertionError(f"lenet: {len(scores)} validations and "
                             f"{len(commits)} snapshots in "
                             f"{LENET['epochs']} epochs")
    if scores[-1]["count"] != LENET["val"]:
        raise AssertionError(f"lenet validation scored "
                             f"{scores[-1]['count']} of {LENET['val']}")
    if not scores[-1]["top1"] > LENET["min_top1"]:
        raise AssertionError(f"lenet Top-1 {scores[-1]['top1']:.4f} after "
                             f"{LENET['epochs']} epochs, want > "
                             f"{LENET['min_top1']}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"lenet: the loss is not finite and falling "
                             f"({first} -> {last})")
    profile = lenet_profile_step(
        init, next(iter(lenet_pipeline(train, True).data(train=False))),
        device, card)
    report["lenet_train"] = {
        "steps": steps, "K": K, "wall_s": wall, "ms_per_step": step_s * 1e3,
        "samples_per_s": LENET["batch"] / step_s, "max_memory_allocated":
        peak, "losses": losses, "validations": scores,
        "snapshots": commits, "driver_stall": stall, "event_bytes": events,
        "launches": launches, "profile": profile}
    return launches


def lenet_cpu_step(init, params, batch):
    """The loss and the gradients of one LeNet step on the CPU (the plain
    versions), from ``params`` on ``batch``."""
    m = copy.deepcopy(init)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
            p.requires_grad_(True)
    loss = nn.ClassNLLCriterion().apply(m(torch.from_numpy(batch.input)),
                                        torch.from_numpy(batch.target))
    loss.backward()
    return loss.item(), {k: p.grad.double() for k, p in m.named_parameters()}


def lenet_logp_reading(model, batches, device):
    """The validation log-probabilities of ``model``'s weights on the card
    against the CPU: the largest difference as a share of max|logp|, over
    ``batches`` (the first and the ragged last)."""
    card = copy.deepcopy(model).to(device).eval()
    cpu = copy.deepcopy(model).eval()
    worst = 0.0
    with torch.no_grad():
        for b in batches:
            x = torch.from_numpy(b.input)
            want = cpu(x)
            got = card(x.to(device)).cpu()
            worst = max(worst, ((got - want).abs().max()
                                / want.abs().max()).item())
    return worst


def lenet_check_phase(seed, device, card, report):
    """One K=LENET["check_K"] block of the recipe on the card through
    LocalOptimizer against the CPU, step by step (wd_step_reading with
    lenet_cpu_step), from
    the same init and batches, and the validation log-probabilities of the
    trained weights on both (lenet_logp_reading); two planted faults on
    the card must read above LENET_TRAIN_TOL: fc1's weight x127/128 at
    init, and B1's first launch x127/128."""
    K, B = LENET["check_K"], LENET["batch"]
    train, val = lenet_data()
    batches = list(lenet_pipeline(train, True, K * B).data(train=False))
    vbatches = list(lenet_pipeline(val, False).data(train=False))
    vbatches = [vbatches[0], vbatches[-1]]
    init = lenet5(10).initialize(seed + 1)

    def card_run(model, b1_fault=False):
        sgd = lenet_sgd(recording(optim.SGD))
        sound_launch = maxpool.launch
        if b1_fault:
            maxpool.launch = planted_b1_fault()
        try:
            losses = []
            opt = (LocalOptimizer(model, lenet_pipeline(train, True, K * B),
                                  nn.ClassNLLCriterion(), device=device)
                   .set_optim_method(sgd).set_steps_per_dispatch(K)
                   .set_end_when(optim.max_iteration(K)))
            opt._log_train_iteration = \
                lambda lr: losses.append(opt.state["loss"])
            opt.optimize()
        finally:
            maxpool.launch = sound_launch
        return losses, sgd.steps

    card_model = copy.deepcopy(init)
    maxpool.reset_counts()
    card_losses, card_steps = card_run(card_model)
    if maxpool.launches != 2 * K:
        raise AssertionError(f"B1 launched {maxpool.launches} times in {K} "
                             f"steps (want 2 a step)")
    sound, worst = wd_step_reading(card_losses, card_steps, init, batches,
                                   lenet_cpu_step)
    logp = lenet_logp_reading(card_model, vbatches, device)
    faults, fault_worst = {}, {}
    m = copy.deepcopy(init)
    with torch.no_grad():
        m[8].weight.mul_(127 / 128)
    for name, (model, b1) in {"fc1_weight_127_128": (m, False),
                              "b1_first_launch_127_128": (
                                  copy.deepcopy(init), True)}.items():
        faults[name], fault_worst[name] = wd_step_reading(
            *card_run(model, b1), init, batches, lenet_cpu_step)
    print(f"lenet train-vs-cpu largest shares (share, what): sound {worst}; "
          + "; ".join(f"{k} {v}" for k, v in fault_worst.items()))
    print(f"lenet train-vs-cpu check, {K} steps of batch {B} step by step: "
          f"sound {sound:.3e}, validation log-probs {logp:.3e} (batches of "
          f"{vbatches[0].size()} and {vbatches[1].size()}), planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {LENET_TRAIN_TOL}); card losses "
          + ", ".join(f"{v:.6f}" for v in card_losses) + f" [{card}]")
    report["lenet_check"] = {"sound": sound, "largest": worst,
                             "logp": logp, "planted_faults": faults,
                             "planted_largest": fault_worst,
                             "tol": LENET_TRAIN_TOL,
                             "card_losses": card_losses}
    if not max(sound, logp) <= LENET_TRAIN_TOL:
        raise AssertionError(f"LeNet on the card is {sound:.3e} (training) / "
                             f"{logp:.3e} (validation log-probs) from the "
                             f"CPU, over the limit {LENET_TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > LENET_TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the LeNet "
                f"training tolerance {LENET_TRAIN_TOL}: the check is blind")


def lenet_resume_run(ckpt, k, device, preempt_at=None, resume=False):
    """The recipe for LENET["resume_iters"] iterations at K=``k`` with a
    snapshot every LENET["resume_every"] into ``ckpt``: ({step: loss},
    optimizer).  ``preempt_at``: the process sends itself SIGTERM while
    that iteration is replayed (preemption handling on); ``resume``:
    resume() from ``ckpt`` first."""
    train, _ = lenet_data()
    losses = {}

    class Recording(LocalOptimizer):
        def _log_train_iteration(self, lr):
            losses[self.state["neval"]] = self.state["loss"]
            if self.state["neval"] == preempt_at:
                if not self._preemption.installed:
                    raise AssertionError("the SIGTERM handler is not "
                                         "installed")
                os.kill(os.getpid(), signal.SIGTERM)

    opt = (Recording(lenet5(10).initialize(7), lenet_pipeline(train, True),
                     nn.ClassNLLCriterion(), device=device)
           .set_optim_method(lenet_sgd()).set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(LENET["resume_iters"]))
           .set_checkpoint(ckpt, optim.several_iteration(
               LENET["resume_every"])))
    if preempt_at is not None:
        opt.set_preemption_handling()
    if resume and not opt.resume():
        raise AssertionError(f"no valid snapshot to resume under {ckpt}")
    start = opt.state["neval"]
    opt.optimize()
    return losses, opt, start


def lenet_resume_phase(device, card, report):
    """Bitwise resume on the card, under torch.use_deterministic_algorithms:
    at K=1 and K=4, an uninterrupted run against a run that a SIGTERM cuts
    mid-epoch (preemption handling: the block in flight finishes, a last
    snapshot is written) and a fresh optimizer's resume() of it: the
    spliced losses and the final weights must equal the uninterrupted
    run's bitwise.  At K=4 the preemption's snapshot is truncated on disk
    first, so latest_valid must skip it and the resume starts from the
    last trigger snapshot."""
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for k in (1, 4):
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.monotonic()
                ref, ref_opt, _ = lenet_resume_run(
                    os.path.join(tmp, "ref"), k, device)
                cut_dir = os.path.join(tmp, "cut")
                first, cut_opt, _ = lenet_resume_run(
                    cut_dir, k, device, preempt_at=LENET["preempt_at"])
                stop = cut_opt.state["neval"]
                if not cut_opt.state.get("preempted") or \
                        not LENET["preempt_at"] <= stop < \
                        LENET["resume_iters"]:
                    raise AssertionError(f"K={k}: the SIGTERM at iteration "
                                         f"{LENET['preempt_at']} did not "
                                         f"preempt the run ({cut_opt.state})")
                mgr = ckpt_manager.CheckpointManager(cut_dir)
                torn = None
                if k == 4:
                    torn = mgr.path_for(stop)
                    with open(torn, "r+b") as f:
                        f.truncate(os.path.getsize(torn) // 2)
                latest = mgr.latest_valid()
                mgr.unpin()
                want = mgr.path_for(LENET["preempt_at"] // LENET[
                    "resume_every"] * LENET["resume_every"]) if torn \
                    else mgr.path_for(stop)
                if latest != want:
                    raise AssertionError(f"K={k}: latest_valid gave "
                                         f"{latest}, want {want}")
                second, res_opt, start = lenet_resume_run(
                    cut_dir, k, device, resume=True)
                spliced = {**first, **second}
                same = sorted(spliced) == sorted(ref) and all(
                    spliced[s] == ref[s] for s in ref)
                params_same = all(torch.equal(a, b) for a, b in zip(
                    res_opt.model.parameters(), ref_opt.model.parameters()))
                print(f"lenet resume K={k}: SIGTERM at iteration "
                      f"{LENET['preempt_at']}, stopped at {stop}"
                      + (f", its snapshot truncated and skipped" if torn
                         else "") + f", resumed from {start} to "
                      f"{res_opt.state['neval']}: losses bitwise {same}, "
                      f"weights bitwise {params_same} "
                      f"({time.monotonic() - t0:.1f} s) [{card}]")
                out[k] = {"stop": stop, "resumed_from": start,
                          "torn": torn is not None, "losses_equal": same,
                          "weights_equal": params_same}
                if not (same and params_same):
                    worst = max(abs(spliced.get(s, float("nan")) - ref[s])
                                for s in ref)
                    raise AssertionError(
                        f"K={k}: the resumed run is not bitwise the "
                        f"uninterrupted one (largest loss difference "
                        f"{worst})")
    finally:
        torch.use_deterministic_algorithms(False)
    report["lenet_resume"] = out


# ------------------------------------------------ DistriOptimizer (slice 9)
# the recipe's DistriOptimizer runs at world 1 over NCCL (one card); the
# world-2 check runs two processes on the one card over gloo (NCCL refuses
# two ranks on one device)
DISTRI = {"pipeline_blocks": 1, "world2": 2, "world2_batch": 64,
          "world2_steps": 8, "resume_images": 16 * 128, "resume_iters": 12,
          "resume_every": 4}
# how far the bf16 wire's f32 masters may stray from the f32 wire's
# weights: the worst leaf's ||w_bf16 - w_f32|| / ||w_f32 - w_0||.  At the
# world-2 check's LeNet the sound wire reads about 0.01 and a wire that
# never updates the weights 1.0 (PERF.md section 2)
WIRE_DRIFT_LIMIT = 0.1
SYNC_PHASES = ("flatten", "wire_cast", "reduce_scatter", "update",
               "all_gather", "unflatten")


def distri_optimizer(model, dataset, device, wire, k, steps, method,
                     compute=None, **kw):
    """The optimizer ``Optimizer.create(..., distributed=True)`` builds,
    recording each step's loss and the host clock at its replay in
    ``opt.losses`` / ``opt.clock``."""
    opt = (optim.Optimizer.create(model, dataset, nn.ClassNLLCriterion(),
                                  distributed=True, device=device,
                                  grad_wire_dtype=wire, **kw)
           .set_optim_method(method).set_compute_dtype(compute)
           .set_steps_per_dispatch(k)
           .set_end_when(optim.max_iteration(steps)))
    opt.losses, opt.clock = [], []

    def log(lr):
        opt.losses.append(opt.state["loss"])
        opt.clock.append(time.perf_counter())
    opt._log_train_iteration = log
    return opt


def sync_phase_kernels(prof):
    """{phase: {kernel: [device ms, launches]}} of the kernels that the
    ``grad_sync.<phase>`` ranges of a profiled step launched: the kernels
    of each host-side range's operations (the range's own device-side
    span, which covers the gaps between them, is left out)."""
    out = {ph: {} for ph in SYNC_PHASES}

    def walk(evt, acc):
        for k in evt.kernels:
            row = acc.setdefault(k.name, [0.0, 0])
            row[0] += k.duration / 1e3
            row[1] += 1
        for ch in evt.cpu_children:
            walk(ch, acc)

    for evt in prof.events():
        ph = evt.name[len("grad_sync."):] \
            if evt.name.startswith("grad_sync.") else None
        if ph in out and evt.device_type.name == "CPU":
            for ch in evt.cpu_children:
                walk(ch, out[ph])
    return out


def distri_profile_step(init, augmented, device, card, wire):
    """The recipe's second step through DistriOptimizer (K=1) under
    torch.profiler: wall ms, device busy ms, idle share, launches, and the
    sync's own device ms by phase (the kernels of the ``grad_sync.<phase>``
    ranges)."""
    from torch.profiler import ProfilerActivity, profile
    B = RESNET["batch"]
    opt = distri_optimizer(copy.deepcopy(init),
                           DataSet.array(augmented) >> SampleToMiniBatch(B),
                           device, wire, 1, 2,
                           recipe_sgd(RESNET["samples"] // B), torch.bfloat16)
    sound_block, out = opt._block, {}

    def block(step_fn, staged, lrs, first_step):
        if first_step != 1:
            return sound_block(step_fn, staged, lrs, first_step)
        staged.wait()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.monotonic()
            losses = sound_block(step_fn, staged, lrs, first_step)
            torch.cuda.synchronize()
            out["wall_ms"] = (time.monotonic() - t1) * 1e3
        busy, kernels, _ = device_time(prof)
        phases = sync_phase_kernels(prof)
        out.update(device_busy_ms=busy,
                   kernel_launches=sum(n for _, _, n in kernels),
                   sync_ms={ph: sum(ms for ms, _ in ks.values())
                            for ph, ks in phases.items()},
                   sync_launches={ph: sum(n for _, n in ks.values())
                                  for ph, ks in phases.items()},
                   sync_kernels={ph: sorted(([k[:60], ms, n] for k, (ms, n)
                                             in ks.items()),
                                            key=lambda r: -r[1])[:4]
                                 for ph, ks in phases.items()},
                   nccl_ms=sum(ms for name, ms, _ in kernels
                               if "nccl" in name.lower()),
                   top=[list(k) for k in kernels[:8]])
        return losses
    opt._block = block
    opt.optimize()
    sync = sum(out["sync_ms"].values())
    idle = "not measured (the profiler saw no device time)" \
        if out["device_busy_ms"] == 0 else \
        f"{max(0.0, 1 - out['device_busy_ms'] / out['wall_ms']):.3f}"
    print(f"profile distri resnet50 step ({wire} wire, world 1 "
          f"{opt.mesh.backend}): "
          f"wall_ms={out['wall_ms']:.2f} device_busy_ms="
          f"{out['device_busy_ms']:.2f} idle_share={idle} kernel_launches="
          f"{out['kernel_launches']}; sync device ms {sync:.3f} in "
          f"{sum(out['sync_launches'].values())} launches: "
          + ", ".join(f"{ph} {ms:.3f} ({out['sync_launches'][ph]})"
                      for ph, ms in out["sync_ms"].items())
          + f" (nccl kernels {out['nccl_ms']:.3f}) [{card}]")
    for ph, rows in out["sync_kernels"].items():
        for name, ms, n in rows:
            print(f"  {ph:>14s} {ms:8.3f} ms x{n:<4d} {name}")
    return out


def distri_resnet_phase(seed, device, card, report):
    """ResNet-50's ImageNet recipe through Optimizer.create(...,
    distributed=True) at world 1 over NCCL, with the f32 wire, then the
    bf16 wire: each a warm-up block and three timed K=4 blocks over the
    pre-augmented images, then a warm-up and DISTRI["pipeline_blocks"]
    timed blocks through the recipe's pipeline (images/s, ms a step from the
    host clock at each block's replay), block losses that must be finite
    and fall, peak memory, the bucket count, B1's launches (one a step,
    bf16, tiled_nhwc); then one profiled step a wire.  Returns B1's
    launches in the f32 pre-augmented run (counts set to 0 just before
    it)."""
    B, K, size = RESNET["batch"], RESNET["K"], RESNET["size"]
    per_epoch = RESNET["samples"] // B
    samples, augmented = resnet_data()
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    runs = {
        "pre_augmented": (lambda: DataSet.array(augmented)
                          >> SampleToMiniBatch(B),
                          K * (1 + RESNET["timed_blocks"])),
        "pipeline": (lambda: DataSet.array(samples) >> MTSampleToMiniBatch(
            B, recipe_augment(size), workers=RESNET["workers"]),
            K * (1 + DISTRI["pipeline_blocks"]))}
    out, main_launches = {}, None
    for wire in ("f32", "bf16"):
        for name, (make, steps) in runs.items():
            t0 = time.monotonic()
            opt = distri_optimizer(copy.deepcopy(init), make(), device, wire,
                                   K, steps, recipe_sgd(per_epoch),
                                   torch.bfloat16)
            torch.cuda.reset_peak_memory_stats()
            maxpool.reset_counts()
            opt.optimize()
            launches = maxpool.launches
            peak = torch.cuda.max_memory_allocated()
            losses, clock = opt.losses, opt.clock
            if launches != steps or opt.state["neval"] != steps or \
                    maxpool.variant_launches["tiled_nhwc"] != steps:
                raise AssertionError(
                    f"distri {wire} {name}: B1 launched {launches} times "
                    f"({maxpool.variant_launches}) in "
                    f"{opt.state['neval']} steps")
            if wire == "f32" and name == "pre_augmented":
                main_launches = launches
            blocks = [float(np.mean(losses[i:i + K]))
                      for i in range(0, steps, K)]
            if not (np.all(np.isfinite(losses)) and blocks[-1] < blocks[0]):
                raise AssertionError(f"distri {wire} {name}: the loss is "
                                     f"not finite and falling: {blocks}")
            plan = opt._gs_plan
            if not opt._use_grad_sync or opt._world != 1 or \
                    opt.mesh.backend != ("nccl" if device.type == "cuda"
                                         else "gloo"):
                raise AssertionError(f"distri {wire} {name}: not the "
                                     f"world-1 nccl grad_sync path")
            ends = [clock[i + K - 1] for i in range(0, steps, K)]
            step_s = (ends[-1] - ends[0]) / (steps - K)
            out[f"{wire}/{name}"] = {
                "ms_per_step": step_s * 1e3, "images_per_s": B / step_s,
                "block_losses": blocks, "losses": losses,
                "max_memory_allocated": peak, "launches": launches,
                "buckets": plan.num_buckets,
                "bucket_sizes": plan.bucket_sizes,
                "wall_s": time.monotonic() - t0}
            print(f"train resnet50 distri world 1 {opt.mesh.backend} {wire} "
                  f"wire {name} "
                  f"NHWC bf16 batch {B} K={K}: {steps} steps, the "
                  f"{steps // K - 1} blocks after the first: ms_per_step="
                  f"{step_s * 1e3:.2f} images_per_s={B / step_s:.1f} "
                  f"max_memory_allocated={peak} buckets={plan.num_buckets} "
                  f"(largest {max(plan.bucket_sizes)} elements) block losses "
                  + ", ".join(f"{v:.4f}" for v in blocks)
                  + f"; B1 launches {launches} for {steps} steps, all bf16 "
                  f"tiled_nhwc; run {time.monotonic() - t0:.1f} s [{card}]")
            del opt
            torch.cuda.empty_cache()
        out[f"{wire}/profile"] = distri_profile_step(init, augmented, device,
                                                     card, wire)
        torch.cuda.empty_cache()
    report["distri_resnet"] = out
    return main_launches


def params_equal(a, b):
    return all(torch.equal(x.detach().cpu(), y.detach().cpu())
               for x, y in zip(a.parameters(), b.parameters()))


def distri_vs_local_phase(seed, device, card, report):
    """World 1 against LocalOptimizer on the card, same seed, weights and
    data, one K=4 block, f32 wire: LeNet-5 (the recipe, under
    torch.use_deterministic_algorithms) and ResNet-50 (the recipe, bf16
    compute, cuDNN's deterministic algorithms) must give the same losses
    and weights bit for bit."""
    out = {}
    K, B = LENET["check_K"], LENET["batch"]
    train, _ = lenet_data()
    init = lenet5(10).initialize(seed + 1)
    torch.use_deterministic_algorithms(True)
    try:
        local = copy.deepcopy(init)
        llosses = []
        lopt = (LocalOptimizer(local, lenet_pipeline(train, True, K * B),
                               nn.ClassNLLCriterion(), device=device)
                .set_optim_method(lenet_sgd()).set_steps_per_dispatch(K)
                .set_end_when(optim.max_iteration(K)))
        lopt._log_train_iteration = \
            lambda lr: llosses.append(lopt.state["loss"])
        lopt.optimize()
        dist_model = copy.deepcopy(init)
        dopt = distri_optimizer(dist_model, lenet_pipeline(train, True, K * B),
                                device, "f32", K, K, lenet_sgd())
        dopt.optimize()
    finally:
        torch.use_deterministic_algorithms(False)
    same = llosses == dopt.losses and params_equal(local, dist_model)
    print(f"lenet distri world 1 vs LocalOptimizer, K={K} block of batch "
          f"{B}: losses and weights bitwise {same} (buckets "
          f"{dopt._gs_plan.num_buckets}); losses "
          + ", ".join(f"{v:.6f}" for v in dopt.losses) + f" [{card}]")
    out["lenet"] = {"bitwise": same, "losses": dopt.losses}
    if not same:
        raise AssertionError(f"LeNet through DistriOptimizer at world 1 is "
                             f"not LocalOptimizer bit for bit: "
                             f"{dopt.losses} vs {llosses}")
    K, B = RESNET["K"], RESNET["batch"]
    _, augmented = resnet_data()
    init = resnet50(RESNET["classes"], format="NHWC").initialize(seed)
    per_epoch = RESNET["samples"] // B
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        local = copy.deepcopy(init)
        llosses, _, lopt, _ = resnet_train(
            local, DataSet.array(augmented) >> SampleToMiniBatch(B), device,
            K, K, torch.bfloat16, per_epoch)
        del lopt
        dist_model = copy.deepcopy(init)
        dopt = distri_optimizer(dist_model, DataSet.array(augmented)
                                >> SampleToMiniBatch(B), device, "f32", K, K,
                                recipe_sgd(per_epoch), torch.bfloat16)
        dopt.optimize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            cudnn
    same = llosses == dopt.losses and params_equal(local, dist_model)
    worst = max(((a.detach() - b.detach()).abs().max()
                 / b.detach().abs().max().clamp(min=1e-30)).item()
                for a, b in zip(dist_model.parameters(), local.parameters()))
    print(f"resnet50 distri world 1 vs LocalOptimizer, K={K} block of batch "
          f"{B} bf16: losses and weights bitwise {same} (largest weight "
          f"difference {worst:.3e} of a layer's largest; buckets "
          f"{dopt._gs_plan.num_buckets}); losses "
          + ", ".join(f"{v:.6f}" for v in dopt.losses) + f" [{card}]")
    out["resnet50"] = {"bitwise": same, "losses": dopt.losses,
                       "local_losses": llosses, "largest": worst}
    report["distri_vs_local"] = out
    if not same:
        raise AssertionError("ResNet-50 through DistriOptimizer at world 1 "
                             "is not LocalOptimizer bit for bit")


WIRE_FAULTS = ("no_update", "stale_gather")


@contextlib.contextmanager
def planted_wire_fault(kind):
    """A deliberately broken wire that the bf16 check must fail:
    ``"no_update"`` (the reduce-scatter delivers zeros, so the weights
    never move) or ``"stale_gather"`` (the all-gather keeps publishing its
    first parameters); None: the sound wire."""
    from bigdl_tpu_torch.parallel import grad_sync
    saved = (grad_sync.reduce_scatter_grads, grad_sync.all_gather_params)
    if kind == "no_update":
        grad_sync.reduce_scatter_grads = lambda *a, **k: [
            torch.zeros_like(o) for o in saved[0](*a, **k)]
    elif kind == "stale_gather":
        first = []

        def stale(*a, **k):
            new = saved[1](*a, **k)
            first.extend(p.clone() for p in new[len(first):])
            return [p.clone() for p in first]
        grad_sync.all_gather_params = stale
    try:
        yield
    finally:
        grad_sync.reduce_scatter_grads, grad_sync.all_gather_params = saved


def wire_drift(params, ref, start):
    """How far a run's weights strayed from the f32 wire's: the worst
    leaf's ``||w - w_f32|| / ||w_f32 - w_0||``."""
    return max(float(np.linalg.norm(params[k] - ref[k])
                     / np.linalg.norm(ref[k] - start[k])) for k in ref)


def bf16_neighbours(run):
    """Whether every weight a bf16-wire run published is one of the two
    bf16 values around its f32 master: what the all-gather's unbiased
    round may give."""
    ok = True
    for pub, master in zip(run["flat"], run["full_masters"]):
        bits = master.view(np.uint32) & 0xFFFF0000
        down, up = bits.view(np.float32), (bits + 0x10000).view(np.float32)
        ok &= bool(np.all((pub == down) | (pub == up)))
    return ok


def distri_world2_worker(rank, world, store_dir, seed, device_type):
    """One process of the world-2 check: LeNet on the one card over gloo,
    five runs (grad_sync f32 wire, the all-reduce path, the bf16 wire, and
    the bf16 wire with each planted fault of WIRE_FAULTS); pickles what
    each ends with to ``store_dir``."""
    import pickle
    import torch.distributed as dist
    from bigdl_tpu_torch.parallel import grad_sync
    if device_type == "cuda":
        torch.cuda.set_device(0)
    torch.use_deterministic_algorithms(True)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(store_dir, "store"), world),
        rank=rank, world_size=world)
    try:
        B, steps = DISTRI["world2_batch"], DISTRI["world2_steps"]
        data = mnist.synthetic_mnist(B * world * steps, seed=0)
        # does gloo itself take CUDA tensors for the bucket collectives?
        probe = {}
        for name, fn, n_out in (("reduce_scatter_tensor",
                                 dist.reduce_scatter_tensor, 2),
                                ("all_gather_into_tensor",
                                 dist.all_gather_into_tensor, 8)):
            try:
                fn(torch.empty(n_out, device=device_type),
                   torch.ones(4, device=device_type))
                probe[name] = "accepted"
            except RuntimeError as e:
                probe[name] = f"refused: {str(e).splitlines()[0][:120]}"
        results = {"gloo_cuda": probe}
        for name, wire, kw in (
                ("f32", "f32", {}),
                ("plain", "f32", {"parameter_sharding": False}),
                ("bf16", "bf16", {}),
                ("no_update", "bf16", {}), ("stale_gather", "bf16", {})):
            model = lenet5(10).initialize(seed + 1)
            init = {k: v.detach().cpu().numpy().copy()
                    for k, v in model.named_parameters()}
            maxpool.reset_counts()
            opt = distri_optimizer(
                model, lenet_pipeline(data, True, batch=B, distributed=True),
                device_type, wire, 4, steps, lenet_sgd(), backend="gloo",
                **kw)
            with planted_wire_fault(name if name in WIRE_FAULTS else None):
                opt.optimize()
            params = dict(model.named_parameters())
            r = {"losses": opt.losses, "launches": maxpool.launches,
                 "init": init,
                 "params": {k: v.detach().numpy().copy()
                            for k, v in params.items()},
                 "backend": opt.mesh.backend, "world": opt._world,
                 "device": str(opt._run_device)}
            if opt._use_grad_sync:
                r["masters"] = [m.cpu().numpy()
                                for m in opt._final_opt_state["master"]]
                r["flat"] = [b.numpy() for b in grad_sync.flatten_to_buckets(
                    opt._gs_plan, [params[n].detach()
                                   for n in opt._gs_names])]
                full = grad_sync.gather_state(
                    opt._gs_plan, opt._final_opt_state)["master"]
                r["full_masters"] = [m.cpu().numpy() for m in full]
                r["master_params"] = {
                    n: v.cpu().numpy() for n, v in zip(
                        opt._gs_names,
                        grad_sync.unflatten_from_buckets(opt._gs_plan, full))}
            results[name] = r
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()


def distri_world2_phase(seed, device, card, report):
    """Two processes on the one card over gloo, CUDA compute, LeNet at batch
    64 a process (global 128), 8 steps in K=4 blocks.  First B1 against its
    plain version, bitwise, at the two pools' shapes at that batch; then:
    the grad_sync f32 wire must equal the all-reduce path bit for bit on
    both ranks, the ranks must agree, each rank's f32 master slices must
    reassemble into the published weights exactly, the bf16 wire's masters
    must stay within WIRE_DRIFT_LIMIT of the f32 wire's weights and its
    published weights must each be one of the two bf16 values around their
    master, each planted fault of WIRE_FAULTS must fail one of those two,
    and B1 must launch 2 a step."""
    import pickle
    gen = torch.Generator(device=device).manual_seed(1618)
    for name in DISTRI_POOL_CASES:
        pool_case_check(next(c for c in POOL_CASES if c[0] == name), gen,
                        device)
    world, steps = DISTRI["world2"], DISTRI["world2_steps"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        torch.multiprocessing.spawn(distri_world2_worker,
                                    args=(world, tmp, seed, device.type),
                                    nprocs=world,
                                    join=True)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    wall = time.monotonic() - t0
    r0 = ranks[0]
    checks = {}
    checks["f32_equals_all_reduce"] = all(
        r["f32"]["losses"] == r["plain"]["losses"] and all(
            np.array_equal(r["f32"]["params"][k], r["plain"]["params"][k])
            for k in r["f32"]["params"]) for r in ranks)
    checks["ranks_agree"] = all(
        r["f32"]["losses"] == r0["f32"]["losses"] and all(
            np.array_equal(r["f32"]["params"][k], r0["f32"]["params"][k])
            for k in r0["f32"]["params"]) for r in ranks)
    checks["masters_reassemble"] = all(
        np.array_equal(np.concatenate([r["f32"]["masters"][b]
                                       for r in ranks]), flat)
        for b, flat in enumerate(r0["f32"]["flat"]))
    l32, l16 = np.array(r0["f32"]["losses"]), np.array(r0["bf16"]["losses"])
    drift = {n: wire_drift(r0[n]["master_params"], r0["f32"]["params"],
                           r0["f32"]["init"])
             for n in ("bf16",) + WIRE_FAULTS}
    rounded = {n: all(bf16_neighbours(r[n]) for r in ranks)
               for n in ("bf16",) + WIRE_FAULTS}
    checks["bf16_tracks_f32"] = bool(np.all(np.isfinite(l16))
                                     and drift["bf16"] <= WIRE_DRIFT_LIMIT)
    checks["bf16_publishes_masters_rounded"] = rounded["bf16"]
    # each planted fault fails one of the two checks above
    checks["no_update_caught"] = drift["no_update"] > WIRE_DRIFT_LIMIT
    checks["stale_gather_caught"] = not rounded["stale_gather"]
    checks["b1_two_a_step"] = all(r[n]["launches"] == 2 * steps
                                  for r in ranks for n in ("f32", "plain",
                                                           "bf16"))
    checks["gloo_cuda_world2"] = all(
        (r[n]["backend"], r[n]["world"], r[n]["device"]) ==
        ("gloo", world, device.type) for r in ranks
        for n in ("f32", "bf16"))
    print(f"distri world 2 (gloo, two processes on one card, LeNet batch "
          f"{DISTRI['world2_batch']} a process, {steps} steps K=4): "
          + ", ".join(f"{k} {v}" for k, v in checks.items())
          + f"; masters' drift from the f32 wire (limit {WIRE_DRIFT_LIMIT}): "
          + ", ".join(f"{n} {v:.4g}" for n, v in drift.items())
          + "; published = masters rounded: "
          + ", ".join(f"{n} {v}" for n, v in rounded.items())
          + f"; bf16 wire's largest loss gap "
          f"{float(np.max(np.abs(l16 - l32))):.3e}; gloo on CUDA tensors "
          f"itself: "
          + ", ".join(f"{k} {v}" for k, v in r0["gloo_cuda"].items())
          + f"; f32 losses " + ", ".join(f"{v:.6f}" for v in l32)
          + f"; {wall:.1f} s [{card}]")
    report["distri_world2"] = {"checks": checks, "wire_drift": drift,
                               "rounded": rounded,
                               "gloo_cuda": r0["gloo_cuda"],
                               "f32_losses": l32.tolist(),
                               "bf16_losses": l16.tolist(), "wall_s": wall}
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"distri world-2 check failed: {failed}")


def distri_resume_run(ckpt, device, resume_from=None):
    train, _ = lenet_data()
    opt = distri_optimizer(lenet5(10).initialize(7),
                           lenet_pipeline(train, True,
                                          DISTRI["resume_images"]),
                           device, "f32", 4, DISTRI["resume_iters"],
                           lenet_sgd())
    opt.set_checkpoint(ckpt, optim.several_iteration(DISTRI["resume_every"]))
    if resume_from is not None and not opt.resume(resume_from):
        raise AssertionError(f"no snapshot at {resume_from}")
    start = opt.state["neval"]
    opt.optimize()
    return opt, start


def distri_resume_phase(device, card, report):
    """The grad_sync state's snapshot and resume at world 1 (LeNet, K=4,
    under torch.use_deterministic_algorithms): a fresh optimizer resumed
    from the uninterrupted run's snapshot at iteration 4 must end where
    that run ends, losses and weights bit for bit; the snapshot holds the
    reference's {"master": [...], "opt": {"velocity": [...]}} layout."""
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ref, _ = distri_resume_run(os.path.join(tmp, "ref"), device)
            snap = os.path.join(tmp, "ref", "model.4")
            blob = load_snapshot(snap)
            layout = (set(blob["opt_state"]) == {"master", "opt"}
                      and set(blob["opt_state"]["opt"]) == {"velocity"}
                      and blob["manifest"]["schema"]["grad_sync"]["enabled"])
            res, start = distri_resume_run(os.path.join(tmp, "res"), device,
                                           resume_from=snap)
    finally:
        torch.use_deterministic_algorithms(False)
    same = ref.losses[start:] == res.losses and \
        params_equal(ref.model, res.model)
    print(f"lenet distri resume (world 1, K=4): resumed from iteration "
          f"{start} to {res.state['neval']}: grad_sync snapshot layout "
          f"{layout}, losses and weights bitwise {same} [{card}]")
    report["distri_resume"] = {"start": start, "bitwise": same,
                               "layout": layout}
    if not (same and layout and start == 4):
        raise AssertionError("the grad_sync snapshot did not resume "
                             "bit for bit")


def distri_phase(seed, device, card, report):
    """The slice-9 phases; returns B1's launches on the main path."""
    t0 = time.monotonic()
    launches = distri_resnet_phase(seed, device, card, report)
    print(f"phase distri-resnet: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    distri_vs_local_phase(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase distri-vs-local: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    distri_world2_phase(seed, device, card, report)
    print(f"phase distri-world2: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    distri_resume_phase(device, card, report)
    print(f"phase distri-resume: {time.monotonic() - t0:.1f} s")
    # the world-1 group the runs started
    torch.distributed.destroy_process_group()
    Engine.set_mesh(None)
    return launches


# ------------------------------------------------- CIFAR-10: VGG, ResNet-20
# The recipes of examples/vgg/train.py and examples/resnet/train_cifar10.py
# on synthetic CIFAR-10 at the real split's sizes (50,000 training and
# 10,000 validation images): batch 128, normalize, pad-4 crop, flip and
# CHW through MTSampleToMiniBatch (8 workers), Top-1 over the validation
# images after every epoch.  HFlip turns two pairs of synthetic classes
# (0/3 and 4/7: the same square and channel, mirrored) into the same
# images, so Top-1 tops out near 0.8 on this data; "min_top1" is the bar.
# The per-sample pipeline holds a step to ~100 ms on the card's host
# (PERF.md section 5), ~40 s an epoch: VGG's LocalOptimizer run takes one
# epoch, ResNet-20's (which launches no kernel) and VGG's DistriOptimizer
# run the "steps" they name, Top-1 at their end; each profiles the block
# (one step, K=1) at "profile_at".
CIFAR = {"train": 50_000, "val": 10_000, "batch": 128, "workers": 8,
         "epochs": 1, "steps": {"resnet20": 150, "vgg_distri": 100},
         "warmup_steps": 20,
         "profile_at": {"vgg": 200, "resnet20": 60, "vgg_distri": 60},
         "check_K": 4, "min_top1": 0.5}
_CIFAR_DATA = {}


def cifar_data():
    """(training, validation) Samples of synthetic_cifar, made once."""
    if not _CIFAR_DATA:
        t0 = time.monotonic()
        _CIFAR_DATA["train"] = cifar.to_samples(
            *cifar.synthetic_cifar(CIFAR["train"]))
        _CIFAR_DATA["val"] = cifar.to_samples(
            *cifar.synthetic_cifar(CIFAR["val"], seed=9))
        print(f"cifar data: synthetic_cifar {CIFAR['train']} training and "
              f"{CIFAR['val']} validation images in "
              f"{time.monotonic() - t0:.1f} s")
    return _CIFAR_DATA["train"], _CIFAR_DATA["val"]


def cifar_augment():
    """The recipes' per-sample training augmentation: normalize, pad 4
    and crop 32, flip, HWC to CHW (each transform made once: it carries
    its random stream)."""
    train_aug = (image.BGRImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD),
                 image.RandomCropper(32, 32, pad=4), image.HFlip(),
                 image.ChannelOrder("CHW"))

    def augment(s):
        for t in train_aug:
            s = next(iter(t(iter([s]))))
        return s
    return augment


def cifar_train_set(samples, distributed=False):
    return (DataSet.array(samples, distributed=distributed)
            >> MTSampleToMiniBatch(CIFAR["batch"], cifar_augment(),
                                   workers=CIFAR["workers"]))


def cifar_val_set(samples):
    return (DataSet.array(samples)
            >> image.BGRImgNormalizer(cifar.TRAIN_MEAN, cifar.TRAIN_STD)
            >> image.ChannelOrder("CHW")
            >> SampleToMiniBatch(CIFAR["batch"], drop_remainder=False))


def cifar_sgd(name):
    """The recipe's SGD: ResNet-20's nesterov with MultiStep at epochs 80
    and 120, VGG's with EpochStep(25, 0.5)."""
    if name == "resnet20":
        return optim.SGD(0.1, momentum=0.9, dampening=0.0, nesterov=True,
                         weight_decay=1e-4,
                         learning_rate_schedule=optim.MultiStep(
                             [80, 120], 0.1, epoch_based=True))
    return optim.SGD(0.01, momentum=0.9, dampening=0.0, weight_decay=5e-4,
                     learning_rate_schedule=optim.EpochStep(25, 0.5))


def cifar_model(name, seed):
    model = resnet_cifar(20, class_num=10) if name == "resnet20" \
        else vgg_for_cifar10(10)
    return model.initialize(seed)


def cifar_run(name, seed, device, card, distributed=False):
    """One recipe run through LocalOptimizer or, ``distributed``, the
    DistriOptimizer the recipe's --distributed builds (over
    ``DataSet.array(..., distributed=True)``; world 1 over NCCL):
    CIFAR["epochs"] epochs, Top-1 over the validation images after every
    epoch, or the CIFAR["steps"] the run names, Top-1 at their end.
    Prints images/s and ms a step (host clock at replay, after the first
    CIFAR["warmup_steps"] steps, up to the first validation), peak
    memory, a profiled block and B1's launches; fails unless the loss
    falls, the last Top-1 passes CIFAR["min_top1"] and B1
    launched 5 times a VGG step (two_pass) and never for ResNet-20."""
    key = name + ("_distri" if distributed else "")
    B, w = CIFAR["batch"], CIFAR["warmup_steps"]
    per_epoch = -(-CIFAR["train"] // B)
    steps = CIFAR["steps"].get(key, CIFAR["epochs"] * per_epoch)
    train, val = cifar_data()
    losses, clock, scores, prof = [], [], [], {}
    cls = optim.DistriOptimizer if distributed else LocalOptimizer

    class Recording(profiled_block(cls, CIFAR["profile_at"][key], card, 8,
                                   prof)):
        def _log_train_iteration(self, lr):
            losses.append(self.state["loss"])
            clock.append(time.perf_counter())

        def _run_validation(self, run):
            t = time.perf_counter()
            res = super()._run_validation(run)
            if res is not None:
                scores.append({"neval": self.state["neval"],
                               "top1": res["Top1Accuracy"].result,
                               "count": res["Top1Accuracy"].count,
                               "s": time.perf_counter() - t})
            return res

    opt = (Recording(cifar_model(name, seed),
                     cifar_train_set(train, distributed),
                     nn.ClassNLLCriterion(), device=device)
           .set_optim_method(cifar_sgd(name))
           .set_end_when(optim.max_iteration(steps))
           .set_validation(optim.several_iteration(steps)
                           if key in CIFAR["steps"] else optim.every_epoch(),
                           cifar_val_set(val),
                           [optim.Top1Accuracy()]))
    torch.cuda.reset_peak_memory_stats()
    maxpool.reset_counts()
    t1 = time.monotonic()
    opt.optimize()
    wall = time.monotonic() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = maxpool.launches
    want = 5 * steps if name == "vgg" else 0
    if opt.state["neval"] != steps or launches != want \
            or maxpool.variant_launches["two_pass"] != want:
        raise AssertionError(f"{key}: {opt.state['neval']} steps, B1 "
                             f"launched {launches} times "
                             f"({maxpool.variant_launches}); want {steps} "
                             f"steps and {want} two_pass launches")
    if distributed and not (opt._world == 1 and opt._use_grad_sync and
                            opt.mesh.backend == ("nccl" if device.type ==
                                                 "cuda" else "gloo")):
        raise AssertionError(f"{key}: not the world-1 grad_sync path")
    end = min(steps, per_epoch) - 1
    step_s = (clock[end] - clock[w]) / (end - w)
    first, last = np.mean(losses[:w]), np.mean(losses[-w:])
    what = {"vgg": "VGG for CIFAR-10", "resnet20": "ResNet-20"}[name]
    route = "DistriOptimizer world 1 " + opt.mesh.backend if distributed \
        else "LocalOptimizer"
    kernel = (f"B1 launches {launches}, 5 a step, all two_pass" if want
              else "no max pool, no kernel: B1 launches 0")
    print(f"train {what} {route} NCHW f32 batch {B}: {steps} steps, "
          f"{wall:.2f} s with validation; steps {w}..{end}: ms_per_step="
          f"{step_s * 1e3:.3f} images_per_s={B / step_s:.1f} "
          f"max_memory_allocated={peak}; mean loss of the first / last {w} "
          f"steps {first:.4f} / {last:.4f}; {kernel} [{card}]")
    for s in scores:
        print(f"{key} validation after iteration {s['neval']}: "
              f"Top1Accuracy={s['top1']:.4f} over {int(s['count'])} images "
              f"in {s['s'] * 1e3:.1f} ms [{card}]")
    print_profile(f"{key} step {CIFAR['profile_at'][key]} (batch {B}, f32)",
                  prof, card)
    if not scores or len(scores) != max(1, steps // per_epoch) \
            or scores[-1]["count"] != CIFAR["val"]:
        raise AssertionError(f"{key}: {len(scores)} validations in {steps} "
                             f"steps, the last over "
                             f"{scores[-1]['count'] if scores else 0} "
                             f"images")
    if not scores[-1]["top1"] > CIFAR["min_top1"]:
        raise AssertionError(f"{key}: Top-1 {scores[-1]['top1']:.4f} after "
                             f"{steps} steps, want > {CIFAR['min_top1']}")
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"{key}: the loss is not finite and falling "
                             f"({first} -> {last})")
    return {"steps": steps, "wall_s": wall, "ms_per_step": step_s * 1e3,
            "images_per_s": B / step_s, "max_memory_allocated": peak,
            "first_loss": first, "last_loss": last, "validations": scores,
            "launches": launches, "profile": prof}


def pool_cases_phase(names, seed, device, card, report, key):
    """B1 at the cases ``names`` of POOL_CASES: bitwise against its plain
    version on integer inputs (ties) in the variant TILED_CASES names,
    then :func:`pool_row` on post-ReLU inputs (time, bound, library)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = {}
    for name in names:
        case = pool_case(name)
        pool_case_check(case, gen, device)
        rows[name] = pool_row(case, gen, device, card)
        torch.cuda.empty_cache()
    report[key] = rows
    return rows


def cifar_distri_vs_local(seed, device, card, report):
    """VGG's world-1 DistriOptimizer (f32 wire) against LocalOptimizer
    over one K-step block of the recipe's pipeline from the same weights,
    under torch.use_deterministic_algorithms: losses and weights must be
    equal bit for bit."""
    K, B = CIFAR["check_K"], CIFAR["batch"]
    train, _ = cifar_data()
    init = cifar_model("vgg", seed + 1)

    def data():
        return DataSet.array(train[:K * B]) >> MTSampleToMiniBatch(
            B, cifar_augment(), workers=CIFAR["workers"])

    torch.use_deterministic_algorithms(True)
    try:
        local = copy.deepcopy(init)
        llosses = []
        lopt = (LocalOptimizer(local, data(), nn.ClassNLLCriterion(),
                               device=device)
                .set_optim_method(cifar_sgd("vgg")).set_steps_per_dispatch(K)
                .set_end_when(optim.max_iteration(K)))
        lopt._log_train_iteration = \
            lambda lr: llosses.append(lopt.state["loss"])
        lopt.optimize()
        dist_model = copy.deepcopy(init)
        dopt = distri_optimizer(dist_model, data(), device, "f32", K, K,
                                cifar_sgd("vgg"))
        dopt.optimize()
    finally:
        torch.use_deterministic_algorithms(False)
    same = llosses == dopt.losses and params_equal(local, dist_model)
    print(f"vgg distri world 1 vs LocalOptimizer, K={K} block of batch {B}: "
          f"losses and weights bitwise {same} (buckets "
          f"{dopt._gs_plan.num_buckets}); losses "
          + ", ".join(f"{v:.6f}" for v in dopt.losses) + f" [{card}]")
    report["cifar_distri_vs_local"] = {"bitwise": same,
                                       "losses": dopt.losses,
                                       "local_losses": llosses}
    if not same:
        raise AssertionError(f"VGG through DistriOptimizer at world 1 is "
                             f"not LocalOptimizer bit for bit: "
                             f"{dopt.losses} vs {llosses}")


def cifar_phase(seed, device, card, report):
    """The CIFAR-10 training phases; returns each run's results (B1's
    launches on the main path: ``["vgg"]["launches"]``)."""
    out = {}
    for name, distributed in (("vgg", False), ("resnet20", False),
                              ("vgg", True)):
        t0 = time.monotonic()
        key = name + ("_distri" if distributed else "")
        out[key] = cifar_run(name, seed, device, card, distributed)
        torch.cuda.empty_cache()
        print(f"phase cifar-{key}: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    cifar_distri_vs_local(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase cifar-distri-vs-local: {time.monotonic() - t0:.1f} s")
    # the world-1 group the runs started
    torch.distributed.destroy_process_group()
    Engine.set_mesh(None)
    report["cifar"] = out
    return out


# ------------------------------------------------------------ Inception v1
# bench.py's configuration of the BigDL whitepaper's model: NHWC, bf16
# compute, batch 256, 224x224, 1000 classes, with the recipe's SGD
# (examples/inception/train.py: lr 0.0898, momentum 0.9, dampening 0,
# weight decay 1e-4, Poly(0.5, 62000)) and augmentation, K=4.  The example's
# synthetic images, 1024 of them, each "repeat" times an epoch: 16 steps,
# four blocks an epoch, so one block in four ends an epoch and has the
# next block staged after it rather than beside it.  Each run times 16
# steps (four blocks, one epoch's end among them).
INCEPTION = {"batch": 256, "K": 4, "size": 224, "classes": 1000,
             "samples": 1024, "repeat": 4, "workers": 8, "timed_blocks": 4,
             "check_batch": 4, "check_K": 4,
             # the check's LRN: an even size (where torch's window differs
             # from the reference's) and alpha 1 (the model's 1e-4 leaves
             # LRN within 1e-3 of the identity, blind to its window)
             "check_lrn": (4, 1.0, 0.75, 1.0)}
# the card against the CPU, step by step: each step's loss and each
# parameter's gradient (||g_card - g_cpu|| / ||g_cpu||), from the card's own
# weights of that step; above the sound readings, below the two planted
# faults that every run measures and requires to exceed it
INCEPTION_TRAIN_TOL = 5e-2
_INCEPTION_DATA = {}


def synthetic_imagenet(n, size=224, classes=1000, seed=0):
    """The Inception example's synthetic stand-in: a class-coloured 56x56
    patch on noise, uint8 HWC."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int32)
    imgs = rng.integers(0, 60, (n, size, size, 3)).astype(np.float32)
    for i, y in enumerate(labels):
        r, c = divmod(int(y) % 16, 4)
        imgs[i, r * 56:(r + 1) * 56, c * 56:(c + 1) * 56, int(y) % 3] += 150
    return imgs.astype(np.uint8), labels


def inception_augment(size, to_chw=False):
    """The recipe's per-sample augmentation (HWC for the NHWC model)."""
    aug = (V.RandomAlterAspect(target_size=size) >> V.HFlip()
           >> V.ChannelNormalize((123.0, 117.0, 104.0), (58.4, 57.1, 57.4))
           >> V.ImageFrameToSample(to_chw=to_chw))
    return lambda s: aug(V.ImageFeature(s.feature, s.label))["sample"]


def inception_data():
    """(samples, their pre-augmented NHWC Samples), made once."""
    if not _INCEPTION_DATA:
        B, size = INCEPTION["batch"], INCEPTION["size"]
        t0 = time.monotonic()
        samples = cifar.to_samples(*synthetic_imagenet(
            INCEPTION["samples"], size, INCEPTION["classes"]))
        it = (DataSet.array(samples) >> MTSampleToMiniBatch(
            B, inception_augment(size), workers=INCEPTION["workers"])).data(
                train=False)
        augmented = [Sample(f, t) for b in it
                     for f, t in zip(b.input, b.target)]
        _INCEPTION_DATA["samples"] = samples
        _INCEPTION_DATA["augmented"] = augmented
        print(f"inception data: {len(samples)} synthetic images, "
              f"pre-augmented in {time.monotonic() - t0:.1f} s (8 workers)")
    return _INCEPTION_DATA["samples"], _INCEPTION_DATA["augmented"]


def inception_sgd(cls=optim.SGD):
    return cls(learning_rate=0.0898, momentum=0.9, dampening=0.0,
               weight_decay=1e-4,
               learning_rate_schedule=optim.Poly(0.5, 62000))


def profiled_block(cls, at, card, top, out):
    """``cls`` (an optimizer) whose block ``at`` (0-based) runs under
    torch.profiler, from its enqueue to the next block's: that block's
    device work, the next block's staging (the data pipeline's wait) and
    the replay of the block before.  ``out`` gets wall ms, device busy ms,
    the idle share and the top kernels and aten operations."""
    from torch.profiler import ProfilerActivity, profile

    class Profiled(cls):
        def _block(self, step_fn, staged, lrs, first_step):
            n = self._blocks_seen = getattr(self, "_blocks_seen", -1) + 1
            if n == at + 1:
                torch.cuda.synchronize()
                wall_ms = (time.monotonic() - self._prof_t0) * 1e3
                self._prof.__exit__(None, None, None)
                busy_ms, kernels, ops = device_time(self._prof)
                out.update(wall_ms=wall_ms, device_busy_ms=busy_ms,
                           idle_share=max(0.0, 1 - busy_ms / wall_ms)
                           if busy_ms else None,
                           kernel_launches=sum(c for _, _, c in kernels),
                           kernels=[list(k) for k in kernels[:top]],
                           ops=[list(o) for o in ops[:top]],
                           steps=len(staged.sizes))
            if n == at:
                torch.cuda.synchronize()
                self._prof = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
                self._prof.__enter__()
                self._prof_t0 = time.monotonic()
            return super()._block(step_fn, staged, lrs, first_step)
    return Profiled


def inception_timed_phase(seed, device, card, report):
    """Inception v1 on the card, timed twice: over batches augmented
    beforehand and through the recipe's own pipeline (MTSampleToMiniBatch,
    8 workers).  Each run: a warm-up K=4 block, the timed blocks (images/s
    and ms a step from the host clock at each block's replay), a profiled
    block (idle share, top device kernels and operations) and a closing
    block; block losses that must be finite and fall, peak memory, B1's
    launches (13 a step, all bf16, all tiled_nhwc).  Returns B1's launches
    in the pre-augmented run."""
    B, K, size = INCEPTION["batch"], INCEPTION["K"], INCEPTION["size"]
    samples, augmented = inception_data()
    r = INCEPTION["repeat"]
    init = inception_v1(INCEPTION["classes"], format="NHWC").initialize(seed)
    datasets = {
        "pre_augmented": lambda: DataSet.array(augmented * r)
        >> SampleToMiniBatch(B),
        "pipeline": lambda: DataSet.array(samples * r)
        >> MTSampleToMiniBatch(B, inception_augment(size),
                               workers=INCEPTION["workers"])}
    out, launches = {}, {}
    sound_launch = maxpool.launch
    timed = INCEPTION["timed_blocks"]
    for name, make in datasets.items():
        t0 = time.monotonic()
        # the warm-up block, the timed ones, one whose replay waits on the
        # profiled block's enqueue (kept out of the timing), the profiled
        # block and the one that closes its window
        steps = K * (timed + 4)
        losses, clock, prof = [], [], {}

        class Recording(profiled_block(LocalOptimizer, timed + 2, card, 10,
                                       prof)):
            def _log_train_iteration(self, lr):
                losses.append(self.state["loss"])
                clock.append(time.perf_counter())

        opt = (Recording(copy.deepcopy(init), make(), nn.ClassNLLCriterion(),
                         device=device)
               .set_optim_method(inception_sgd())
               .set_compute_dtype(torch.bfloat16).set_steps_per_dispatch(K)
               .set_end_when(optim.max_iteration(steps)))
        torch.cuda.reset_peak_memory_stats()
        maxpool.reset_counts()
        dtypes = []  # of every B1 launch: the activations are bf16

        def launch(x, *a):
            dtypes.append(x.dtype)
            return sound_launch(x, *a)
        maxpool.launch = launch
        try:
            opt.optimize()
        finally:
            maxpool.launch = sound_launch
        launches[name] = maxpool.launches
        peak = torch.cuda.max_memory_allocated()
        if opt.state["neval"] != steps or launches[name] != 13 * steps \
                or maxpool.variant_launches["tiled_nhwc"] != 13 * steps:
            raise AssertionError(f"inception {name}: B1 launched "
                                 f"{launches[name]} times "
                                 f"({maxpool.variant_launches}) in "
                                 f"{opt.state['neval']} steps; want 13 "
                                 f"tiled_nhwc a step")
        if set(dtypes) != {torch.bfloat16}:
            raise AssertionError(f"inception {name}: B1 ran on "
                                 f"{set(dtypes)}, not on bf16")
        blocks = [float(np.mean(losses[i:i + K]))
                  for i in range(0, steps, K)]
        if not (np.all(np.isfinite(losses)) and blocks[-1] < blocks[0]):
            raise AssertionError(f"inception {name}: the loss is not finite "
                                 f"and falling: {blocks}")
        # block b's losses come back after block b+1 is enqueued: the
        # clock at the last step of each block marks that block's end
        ends = [clock[i + K - 1] for i in range(0, K * (timed + 1), K)]
        step_s = (ends[-1] - ends[0]) / (K * timed)
        out[name] = {"ms_per_step": step_s * 1e3,
                     "images_per_s": B / step_s, "block_losses": blocks,
                     "losses": losses, "max_memory_allocated": peak,
                     "launches": launches[name], "profile": prof,
                     "wall_s": time.monotonic() - t0}
        print(f"train inception_v1 {name} NHWC bf16 batch {B} K={K}: "
              f"{steps} steps, the {timed} timed blocks after the first: "
              f"ms_per_step={step_s * 1e3:.2f} images_per_s="
              f"{B / step_s:.1f} max_memory_allocated={peak} block losses "
              + ", ".join(f"{v:.4f}" for v in blocks)
              + f"; B1 launches {launches[name]} for {steps} steps, 13 a "
              f"step, all bf16 tiled_nhwc; run {time.monotonic() - t0:.1f} "
              f"s [{card}]")
        print_profile(f"inception_v1 {name} block {timed + 2} ({K} steps "
                      f"of batch {B}, bf16)", prof, card)
        del opt
        torch.cuda.empty_cache()
    report["inception_train"] = out
    return launches["pre_augmented"]


def inception_check_model(seed):
    """The check's Inception v1: NCHW f32, the LRNs at INCEPTION["check_lrn"]
    and dropout off (its mask comes from the card's generator, which the
    CPU cannot redraw)."""
    model = inception_v1(INCEPTION["classes"]).initialize(seed)
    size, alpha, beta, k = INCEPTION["check_lrn"]
    for m in model.modules():
        if isinstance(m, nn.SpatialCrossMapLRN):
            m.size, m.alpha, m.beta, m.k = size, alpha, beta, k
        if isinstance(m, nn.Dropout):
            m.p = 0.0
    return model


def inception_cpu_step(init, params, batch):
    """The loss and the gradients of one check step on the CPU (the plain
    versions), from ``params`` on ``batch``."""
    m = copy.deepcopy(init)
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
            p.requires_grad_(True)
    loss = nn.ClassNLLCriterion().apply(m(torch.from_numpy(batch.input)),
                                        torch.from_numpy(batch.target))
    loss.backward()
    return loss.item(), {k: p.grad.double() for k, p in m.named_parameters()}


@contextlib.contextmanager
def planted_inception_fault(kind):
    """A fault of the card run: ``"lrn_torch_window"`` (the LRNs through
    ``torch.nn.functional.local_response_norm``, whose even window sits
    one channel lower than the reference's) or ``"concat_towers_swapped"``
    (module 4a concatenates its 3x3 and 5x5 towers the other way round);
    None: sound."""
    sound = {nn.SpatialCrossMapLRN: nn.SpatialCrossMapLRN.forward,
             nn.Concat: nn.Concat.forward}
    if kind == "lrn_torch_window":
        nn.SpatialCrossMapLRN.forward = \
            lambda self, x: torch.nn.functional.local_response_norm(
                x, self.size, self.alpha, self.beta, self.k)
    elif kind == "concat_towers_swapped":
        def forward(self, x):
            outs = [m(x) for m in self._modules.values()]
            if self.name == "4a":
                outs[1], outs[2] = outs[2], outs[1]
            return torch.cat(outs, self.dim)
        nn.Concat.forward = forward
    elif kind is not None:
        raise ValueError(f"unknown planted fault {kind!r}")
    try:
        yield
    finally:
        for cls, fn in sound.items():
            cls.forward = fn


def inception_check_phase(seed, device, card, report):
    """Inception v1 in NCHW f32 at batch INCEPTION["check_batch"] through
    one K=4 LocalOptimizer block on the card (B1 two_pass, 13 launches a
    step) against the CPU, step by step (:func:`wd_step_reading` with
    :func:`norm_share`), with
    the recipe's SGD; the two planted faults of
    :func:`planted_inception_fault` must read above INCEPTION_TRAIN_TOL."""
    K, B = INCEPTION["check_K"], INCEPTION["check_batch"]
    samples, _ = inception_data()
    it = (DataSet.array(samples[:K * B]) >> MTSampleToMiniBatch(
        B, inception_augment(INCEPTION["size"], to_chw=True),
        workers=INCEPTION["workers"])).data(train=False)
    batches = list(it)
    flat = [Sample(f, t) for b in batches for f, t in zip(b.input, b.target)]
    init = inception_check_model(seed + 1)

    def card_run(fault=None):
        sgd = inception_sgd(recording(optim.SGD))
        losses = []
        opt = (LocalOptimizer(copy.deepcopy(init),
                              DataSet.array(flat) >> SampleToMiniBatch(B),
                              nn.ClassNLLCriterion(), device=device)
               .set_optim_method(sgd).set_steps_per_dispatch(K)
               .set_end_when(optim.max_iteration(K)))
        opt._log_train_iteration = lambda lr: losses.append(opt.state["loss"])
        with planted_inception_fault(fault):
            opt.optimize()
        return losses, sgd.steps

    maxpool.reset_counts()
    card_losses, card_steps = card_run()
    launches = maxpool.launches
    if launches != 13 * K or \
            maxpool.variant_launches["two_pass"] != 13 * K:
        raise AssertionError(f"B1 launched {launches} times "
                             f"({maxpool.variant_launches}) in {K} NCHW "
                             f"steps (want 13 two_pass a step)")
    sound, worst = wd_step_reading(card_losses, card_steps, init, batches,
                                   inception_cpu_step, norm_share)
    faults, fault_worst = {}, {}
    for fault in ("lrn_torch_window", "concat_towers_swapped"):
        faults[fault], fault_worst[fault] = wd_step_reading(
            *card_run(fault), init, batches, inception_cpu_step, norm_share)
    print(f"inception train-vs-cpu largest shares (share, what): sound "
          f"{worst}; " + "; ".join(f"{k} {v}" for k, v in fault_worst.items()))
    print(f"inception train-vs-cpu check, NCHW f32, {K} steps of batch {B} "
          f"step by step: sound {sound:.3e}, planted faults "
          + ", ".join(f"{k} {v:.3e}" for k, v in faults.items())
          + f" (tol {INCEPTION_TRAIN_TOL}); card losses "
          + ", ".join(f"{v:.6f}" for v in card_losses) + f" [{card}]")
    report["inception_check"] = {"sound": sound, "largest": worst,
                                 "planted_faults": faults,
                                 "planted_largest": fault_worst,
                                 "tol": INCEPTION_TRAIN_TOL,
                                 "card_losses": card_losses,
                                 "launches": launches}
    if not sound <= INCEPTION_TRAIN_TOL:
        raise AssertionError(f"Inception v1 on the card is {sound:.3e} from "
                             f"the CPU, over the limit {INCEPTION_TRAIN_TOL}")
    for fault, err in faults.items():
        if not err > INCEPTION_TRAIN_TOL:
            raise AssertionError(
                f"planted fault {fault} reads {err:.3e}, inside the "
                f"Inception tolerance {INCEPTION_TRAIN_TOL}: the check is "
                f"blind")


def inception_phase(seed, device, card, report):
    """The Inception v1 training phases; returns B1's launches on the main
    path (the pre-augmented timed run)."""
    t0 = time.monotonic()
    launches = inception_timed_phase(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase inception-timed: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    inception_check_phase(seed, device, card, report)
    torch.cuda.empty_cache()
    print(f"phase inception-vs-cpu: {time.monotonic() - t0:.1f} s")
    return launches


PHASES = ("resnet", "lstm", "resnet-train", "wide-deep", "lenet",
          "distri", "cifar", "inception")
EXTRA_PHASES = ("resnet-conditioning",)  # run only when named


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="also write the full report to this JSON file")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         + ",".join(PHASES + EXTRA_PHASES) + " (default: "
                         + ",".join(PHASES) + "; the kernels line lists the "
                           "phases run)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES + EXTRA_PHASES):
        ap.error(f"unknown phases "
                 f"{sorted(phases - set(PHASES + EXTRA_PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); the port's smoke test runs only on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    print(f"device: {name} x{count}; nvidia-smi: {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.monotonic()
    for lib in _build.SOURCES:  # the first load builds every library
        _build.load(lib)
    print(f"build: {time.monotonic() - t0:.1f} s (nvcc, one process a "
          f"source, {_build.build_seconds:.1f} s)")
    for lib, text in _build.ptxas_report.items():
        for line in text.splitlines():
            print(f"ptxas[{lib}]: {line.strip()}")
    print(f"phase build: {time.monotonic() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    report = {"card": card, "device": name, "shapes": [], "serving": {},
              "profile": {}}
    kernels = []
    if "resnet" in phases:
        t0 = time.monotonic()
        probe = quantize(resnet50().initialize(args.seed)).to(device)
        shapes = gemm_shapes(probe, device)
        del probe
        if len(shapes) != 54:
            raise AssertionError(f"ResNet-50 forward ran {len(shapes)} GEMMs")
        print(f"resnet50 batch {BATCH}: {len(shapes)} GEMM launches per "
              f"forward, {len(set(shapes))} distinct shapes")
        totals = kernel_phase(shapes, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase int8-kernels: {time.monotonic() - t0:.1f} s")

        t0 = time.monotonic()
        for mode in ("weight_only", "dynamic"):
            profile_phase(mode, args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase int8-profile: {time.monotonic() - t0:.1f} s")

        t0 = time.monotonic()
        launches = {m: serving_phase(m, args.seed, device, card, report)
                    for m in ("weight_only", "dynamic")}
        torch.cuda.empty_cache()
        print(f"phase serving: {time.monotonic() - t0:.1f} s")
        for mode in ("weight_only", "dynamic"):
            t = totals[mode]
            kernels.append({
                "name": f"int8_gemm[{mode}]", **KERNEL,
                "launches": launches[mode], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
                else "operations",
                **({"bound_cuda_cores_ms": t["bound_cuda_cores_ms"]}
                   if mode == "weight_only" else {}),
                "library_ms": t["library_ms"],
                "variant_launches": report["serving"][mode][
                    "variant_launches"],
                "event_ms": t["event_ms"],
                "library_event_ms": t["library_event_ms"]})

    if "lstm" in phases:
        t0 = time.monotonic()
        rows = lstm_kernel_phase(device, card, report)
        print(f"phase lstm-kernels: {time.monotonic() - t0:.1f} s")
        launches = training_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        for kernel, row in rows.items():
            kernels.append({"name": kernel, **LSTM_KERNELS[kernel],
                            "launches": launches[kernel], **row})

    if "resnet-train" in phases:
        t0 = time.monotonic()
        row = pool_kernel_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase pool-kernel: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches = resnet_timed_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase resnet-train-timed: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        resnet_check_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase resnet-train-vs-cpu: {time.monotonic() - t0:.1f} s")
        kernels.append({"name": "maxpool_bwd", **POOL_KERNEL,
                        "launches": launches,
                        **{k: row[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "variant")},
                        "f32": {k: report["pool_kernel"]["stem_nhwc_f32"][k]
                                for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms")}})
    if "wide-deep" in phases:
        t0 = time.monotonic()
        row = bag_kernel_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase bag-kernel: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches = wd_timed_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase wide-deep-timed: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        wd_check_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase wide-deep-vs-cpu: {time.monotonic() - t0:.1f} s")
        kernels.append({"name": "embed_bag", **BAG_KERNEL,
                        "launches": launches,
                        **{k: row[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                        "split": row["split"],
                        "library_route_ms": row["library_route_ms"],
                        "table_grad": {k: report["bag_kernel"]["table_grad"][k]
                                       for k in ("ms", "split", "plain_ms",
                                                 "bound_ms", "library_ms",
                                                 "library_route_ms")}})
    if "lenet" in phases:
        t0 = time.monotonic()
        rows = lenet_pool_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase lenet-pool: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches = lenet_timed_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase lenet-timed: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        lenet_check_phase(args.seed, device, card, report)
        torch.cuda.empty_cache()
        print(f"phase lenet-vs-cpu: {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        lenet_resume_phase(device, card, report)
        torch.cuda.empty_cache()
        print(f"phase lenet-resume: {time.monotonic() - t0:.1f} s")
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "variant")
        lenet_row = {"launches": launches,
                     **{name: {k: row[k] for k in keys}
                        for name, row in rows.items()}}
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # the stem was not run: LeNet's first pool leads
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": launches,
                     **{k: rows[LENET_POOL_CASES[0]][k] for k in keys}}
            kernels.append(entry)
        entry["lenet"] = lenet_row
    if "distri" in phases:
        launches = distri_phase(args.seed, device, card, report)
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # the stem was not checked: check and time it
            gen = torch.Generator(device=device).manual_seed(2718)
            row = pool_row(pool_case("stem_nhwc_bf16"), gen, device, card)
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": launches,
                     **{k: row[k] for k in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "variant")}}
            kernels.append(entry)
        entry["distri"] = {"launches": launches}
    pool_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "variant")
    # B1 at both paths' pools, bitwise and timed; then their training runs
    pool_rows = {}
    for phase, names, pool_seed in (("cifar", VGG_POOL_CASES, 1618),
                                    ("inception", INCEPTION_POOL_CASES, 1414)):
        if phase in phases:
            t0 = time.monotonic()
            pool_rows[phase] = pool_cases_phase(names, pool_seed, device, card,
                                                report, f"{phase}_pool")
            print(f"phase {phase}-pool: {time.monotonic() - t0:.1f} s")
    for phase, run in (("cifar", cifar_phase), ("inception", inception_phase)):
        if phase not in phases:
            continue
        runs, rows = run(args.seed, device, card, report), pool_rows[phase]
        launches = runs["vgg"]["launches"] if phase == "cifar" else runs
        entry = next((k for k in kernels if k["name"] == "maxpool_bwd"),
                     None)
        if entry is None:  # no earlier path ran B1: this one leads
            first = next(iter(rows.values()))
            entry = {"name": "maxpool_bwd", **POOL_KERNEL,
                     "launches": launches,
                     **{k: first[k] for k in pool_keys}}
            kernels.append(entry)
        entry[phase] = {"launches": launches,
                        **{name: {k: row[k] for k in pool_keys}
                           for name, row in rows.items()}}
        if phase == "cifar":
            entry[phase]["vgg_distri_launches"] = \
                runs["vgg_distri"]["launches"]
            entry[phase]["resnet20_launches"] = runs["resnet20"]["launches"]
        else:
            entry[phase]["check_launches"] = \
                report["inception_check"]["launches"]
    if "resnet-conditioning" in phases:
        t0 = time.monotonic()
        resnet_conditioning_phase(args.seed, device, card, report)
        print(f"phase resnet-conditioning: {time.monotonic() - t0:.1f} s")
    report["kernels"] = kernels
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
