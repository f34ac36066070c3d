"""Smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one NVIDIA card.

Drives the port's main path — an int8-quantized ResNet-50 (1000 classes,
224x224, NCHW, random weights from a seed) served by ``ModelRegistry`` with
``quantize=True`` (weight_only) and ``quantize="dynamic"`` — and holds every
kernel of that path against its plain PyTorch version:

1. the card: name, count, ``nvidia-smi`` name and power limit;
2. the kernels, built from ``bigdl_tpu_torch/csrc`` (build seconds and the
   ``-Xptxas -v`` report);
3. kernel phase: every distinct GEMM of a batch-32 ResNet-50 forward (and
   the same K, O at 1 and 37 rows), in both modes, with and without bias,
   weight_only in f32 and bf16, against ``int8_matmul_reference`` on the
   card (dynamic bitwise, weight_only within ``rtol=1e-5,
   atol=1e-5*max|y|``), then kernel, plain and library times with CUDA
   events and the least time the card could take (the bound);
4. profile phase, per mode: device time by kernel of one batch-32
   forward (torch.profiler) against its wall time;
5. serving phase, per mode: 8 client threads x 16 requests of 1-4 rows,
   then 4 sampled requests served alone that must agree with the same
   model run on the CPU through the plain versions within 1e-5 of
   max|y|, a limit that two planted faults must exceed; the kernel's launch
   count must equal 54 x dispatches and warmup must not grow.

The last two lines are the kernel table and the result as JSON; any
failed check raises and the script exits non-zero.  Without a CUDA card it
fails at once.  Run from the repository root:

    python3 chip_smoke.py [--seed N] [--json-out PATH]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from bigdl_tpu_torch.models import resnet50
from bigdl_tpu_torch.nn import quantize
from bigdl_tpu_torch.nn.quantized import (QuantizedLinear,
                                          QuantizedSpatialConvolution)
from bigdl_tpu_torch.ops import _build, int8_gemm
from bigdl_tpu_torch.ops.int8_gemm import (int8_matmul_reference,
                                           prepare_operands)
from bigdl_tpu_torch.serving import ModelRegistry

# H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32 = 67e12       # FLOP/s on the CUDA cores (weight_only's FMAs)
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


def bound(M, K, O, bias, xdtype):
    """(least ms, "bytes" | "operations", peak used) for one GEMM: each
    input read once, the output written once, against the card's memory
    rate and the peak rate of the operations' type."""
    xbytes = {"float32": 4, "bfloat16": 2, "int8": 1}[xdtype]
    nbytes = M * K * xbytes + O * K + 4 * O * (2 if bias else 1) + 4 * M * O
    peak = PEAK_INT8 if xdtype == "int8" else PEAK_F32
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, 2.0 * M * K * O / peak * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", peak)


def library_call(xin, wq, scale, b, xdtype):
    """One PyTorch call for the same product, or None where its shape
    rules refuse: addmm/mm on dequantized weights (weight_only), _int_mm
    (dynamic, int32 product only).  A yardstick; the port never calls it."""
    if xdtype != "int8":
        w = (wq.float() * scale[:, None]).T
        x = xin.float()
        return (lambda: torch.addmm(b, x, w)) if b is not None \
            else (lambda: torch.mm(x, w))
    M, K = xin.shape
    if M <= 16 or K % 8 or wq.shape[0] % 8:
        return None
    wt = wq.T
    try:
        torch._int_mm(xin, wt)
    except RuntimeError:
        return None
    return lambda: torch._int_mm(xin, wt)


def kernel_phase(shapes, device, card, report):
    gen = torch.Generator(device=device).manual_seed(1234)
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    errs = {"float32": 0.0, "bfloat16": 0.0, "int8": 0.0}
    n_checked = 0
    for (M, K, O, _) in counts:
        for m in (M, 1, 37):
            for xdtype in ("float32", "bfloat16", "int8"):
                for bias in (False, True):
                    xin, wq, scale, b = operands(m, K, O, xdtype, bias, gen,
                                                 device)
                    got = int8_gemm.launch(xin, wq, scale, b)
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

    totals = {}
    for (M, K, O, bias), n in counts.items():
        for xdtype in ("float32", "int8"):
            mode = "dynamic" if xdtype == "int8" else "weight_only"
            xin, wq, scale, b = operands(M, K, O, xdtype, bias, gen, device)
            k_ms = cuda_ms(lambda: int8_gemm.launch(xin, wq, scale, b))
            p_ms = cuda_ms(lambda: int8_matmul_reference(xin, wq, scale, b),
                           budget_ms=10.0)
            lib = library_call(xin, wq, scale, b, xdtype)
            l_ms = cuda_ms(lib) if lib is not None else None
            b_ms, b_by, peak = bound(M, K, O, bias, xdtype)
            row = {"mode": mode, "M": M, "K": K, "O": O, "bias": bias,
                   "launches_per_forward": n, "kernel_ms": k_ms,
                   "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "peak": peak}
            report["shapes"].append(row)
            lib_txt = "n/a" if l_ms is None else f"{l_ms:.4f}"
            print(f"gemm {mode:11s} M={M:6d} K={K:4d} O={O:4d} "
                  f"bias={int(bias)} x{n}: kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} library_ms={lib_txt} "
                  f"bound_ms={b_ms:.4f} ({b_by}, peak {peak / 1e12:.0f}T) "
                  f"[{card}]")
            t = totals.setdefault(mode, {
                "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0})
            t["ms"] += n * k_ms
            t["plain_ms"] += n * p_ms
            t["bound_ms"] += n * b_ms
            t["library_ms"] = (None if l_ms is None or t["library_ms"] is None
                               else t["library_ms"] + n * l_ms)
            t["bytes_ms" if b_by == "bytes" else "ops_ms"] += n * b_ms
            del xin, wq, scale, b
    for mode, t in totals.items():
        t["max_abs_err"] = errs["int8" if mode == "dynamic" else "float32"]
    return totals


def profile_phase(mode, seed, device, card, report):
    """Where one batch-32 forward's time goes: torch.profiler's device
    time by kernel over one forward after a warmup, against the forward's
    host-clock wall time (device idle share = 1 - busy / wall)."""
    from torch.autograd import DeviceType
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
    events = prof.key_averages()
    # kernel-side events only (each launch counted once); the aten ops
    # that launched them carry the same time, used below for attribution
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    gemm_ms = sum(e.self_device_time_total for e in kernels
                  if "gemm_" in e.key) / 1e3
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda t: -t[1])
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

        int8_gemm.launches = 0
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
        dispatches = svc.stats()["dispatch_count"]
        peak_mem = torch.cuda.max_memory_allocated()
    if launches != 54 * dispatches or dispatches == 0:
        raise AssertionError(f"{mode}: {launches} kernel launches for "
                             f"{dispatches} dispatches (want 54 each)")
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
          f"{launches} kernel launches for {dispatches} dispatches, "
          f"throughput_rps={stats['throughput_rps']} "
          f"p50_ms={lat['p50']} p99_ms={lat['p99']} "
          f"occupancy={stats['mean_batch_occupancy']} "
          f"compile_count={stats['compile_count']} deploy_s={deploy_s:.2f} "
          f"wall_s={wall:.2f} max_memory_allocated={peak_mem} "
          f"cpu_rel_err={worst:.3e} (tol {SERVE_TOL[mode]}) [{card}]")
    report["serving"][mode] = {
        "stats": stats, "launches": launches, "deploy_s": deploy_s,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None,
                    help="also write the full report to this JSON file")
    args = ap.parse_args(argv)
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
    _build.load("int8_gemm")
    print(f"build: {time.monotonic() - t0:.1f} s (nvcc "
          f"{_build.build_seconds:.1f} s)")
    for lib, text in _build.ptxas_report.items():
        for line in text.splitlines():
            print(f"ptxas[{lib}]: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    report = {"card": card, "device": name, "shapes": [], "serving": {},
              "profile": {}}
    probe = quantize(resnet50().initialize(args.seed)).to(device)
    shapes = gemm_shapes(probe, device)
    del probe
    if len(shapes) != 54:
        raise AssertionError(f"ResNet-50 forward ran {len(shapes)} GEMMs")
    print(f"resnet50 batch {BATCH}: {len(shapes)} GEMM launches per forward, "
          f"{len(set(shapes))} distinct shapes")
    totals = kernel_phase(shapes, device, card, report)
    torch.cuda.empty_cache()

    for mode in ("weight_only", "dynamic"):
        profile_phase(mode, args.seed, device, card, report)
    torch.cuda.empty_cache()

    launches = {m: serving_phase(m, args.seed, device, card, report)
                for m in ("weight_only", "dynamic")}

    kernels = []
    for mode in ("weight_only", "dynamic"):
        t = totals[mode]
        kernels.append({
            "name": f"int8_gemm[{mode}]", **KERNEL,
            "launches": launches[mode], "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes_ms"] >= t["ops_ms"]
            else "operations",
            "library_ms": t["library_ms"]})
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
