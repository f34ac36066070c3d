"""Per-layer timing and ``torch.profiler`` integration (port of
``bigdl_tpu/utils/profiling.py``).

Reference: ``AbstractModule.scala:254-287`` — every module self-times
``forwardTime``/``backwardTime``; ``getTimes()`` aggregates per layer.

- :func:`get_times` — per-leaf forward and backward times of a module
  tree on real inputs (the ``getTimes()`` analog).  On a CUDA device each
  is timed with CUDA events around the layer's launches; on the CPU with
  the wall clock.
- :func:`profile_window` / :func:`profile_step` — a ``torch.profiler``
  capture (CPU activity, and the card's kernels where CUDA is present),
  written as a Chrome trace (``trace.json``) into a log directory; the
  admin plane's ``/profile?seconds=N`` is :func:`profile_window`.  Both
  are the opt-in deep dive: they synchronize the device, which the
  always-on telemetry never does.
"""

from __future__ import annotations

import os
import tempfile
import time
from contextlib import nullcontext
from typing import Any, Callable, List, Optional, Tuple

import torch

from bigdl_tpu_torch.nn.module import Sequential

TRACE_FILE = "trace.json"


class LayerTime:
    __slots__ = ("name", "forward_s", "backward_s")

    def __init__(self, name: str, forward_s: float, backward_s: float):
        self.name = name
        self.forward_s = forward_s
        self.backward_s = backward_s

    def __repr__(self):
        return (f"{self.name}: fwd {self.forward_s * 1e3:.3f}ms "
                f"bwd {self.backward_s * 1e3:.3f}ms")


def _timer(device: torch.device) -> Callable[[Callable[[], Any], int],
                                            float]:
    """``time(fn, repeats)``: seconds a call of ``fn`` takes on
    ``device`` — CUDA events around the launches on the card, the wall
    clock on the CPU."""
    if device.type == "cuda":
        def cuda_time(fn, repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / repeats
        return cuda_time

    def wall_time(fn, repeats):
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats
    return wall_time


def _leaf_time(m: torch.nn.Module, x, repeats: int,
               timer) -> Tuple[Any, float, float]:
    """One leaf's forward, then its backward (the gradient of its
    parameters and of its floating inputs) from an all-ones cotangent."""
    def as_input(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.detach().requires_grad_(True)
        return a

    def fwd():
        with torch.no_grad():
            return m(x)

    fwd()  # warm (kernel builds, allocator)
    f_s = timer(fwd, repeats)
    xg = as_input(x) if isinstance(x, torch.Tensor) else x
    y = m(xg)
    wrt = [p for p in m.parameters() if p.requires_grad]
    if isinstance(xg, torch.Tensor) and xg.requires_grad:
        wrt.append(xg)
    b_s = 0.0
    if wrt and isinstance(y, torch.Tensor) and y.requires_grad:
        ct = torch.ones_like(y)

        def bwd():
            torch.autograd.grad(y, wrt, ct, retain_graph=True)

        bwd()
        b_s = timer(bwd, repeats)
    return y.detach() if isinstance(y, torch.Tensor) else y, f_s, b_s


def get_times(model: torch.nn.Module, input, *,
              repeats: int = 3) -> List[LayerTime]:
    """Per-layer forward+backward timings (reference
    ``AbstractModule.getTimes``).  Walks a ``Sequential`` tree, timing
    each leaf on the activations the layers before it produce; any other
    container is timed as one unit.  The model runs in eval mode on its
    parameters' device.  Returns the leaves in execution order plus a
    TOTAL row."""
    params = list(model.parameters())
    device = params[0].device if params else torch.device("cpu")
    timer = _timer(device)
    times: List[LayerTime] = []
    was_training = model.training
    model.eval()

    def walk(m, x, prefix=""):
        label = f"{prefix}{getattr(m, 'name', type(m).__name__)}"
        if isinstance(m, Sequential) and len(m):
            for c in m._modules.values():
                x = walk(c, x, prefix=label + "/")
            return x
        y, f_s, b_s = _leaf_time(m, x, repeats, timer)
        times.append(LayerTime(label, f_s, b_s))
        return y

    try:
        t0 = time.perf_counter()
        walk(model, input)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        total = time.perf_counter() - t0
    finally:
        model.train(was_training)
    times.append(LayerTime("TOTAL(walk)", total, 0.0))
    return times


def format_times(times: List[LayerTime]) -> str:
    """Pretty table, slowest layer first (reference ``getTimes`` print
    style)."""
    body = sorted((t for t in times if not t.name.startswith("TOTAL")),
                  key=lambda t: -(t.forward_s + t.backward_s))
    width = max((len(t.name) for t in times), default=10)
    lines = [f"{'layer':<{width}}  {'fwd(ms)':>9}  {'bwd(ms)':>9}"]
    for t in body:
        lines.append(f"{t.name:<{width}}  {t.forward_s * 1e3:>9.3f}  "
                     f"{t.backward_s * 1e3:>9.3f}")
    return "\n".join(lines)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _write_trace(prof, log_dir: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# host calls that launch a kernel, as a profiler trace names them
_LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx"))
# a window whose trace records kernel launches and no device activity at
# all is the profiler's fault (torch 2.11's kineto on an H100 now and then
# hands back such a session, see PERF.md) and is taken again, this many
# times at most
WINDOW_RETAKES = 3


def _device_counts(prof) -> Tuple[int, int]:
    """(device activities, kernel launch calls) in a finished session."""
    from torch.autograd import DeviceType
    device = launches = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            device += 1
        elif e.name() in _LAUNCH_CALLS:
            launches += 1
    return device, launches


def profile_window(seconds: float, log_dir: Optional[str] = None,
                   tracer=None, stats: Optional[dict] = None) -> str:
    """Wall-clock ``torch.profiler`` capture: whatever the process runs
    for the next ``seconds`` (the card's kernels included, from any
    thread) lands in ``<log_dir>/trace.json``.  The admin plane's
    ``/profile?seconds=N`` endpoint is a thin shim over this — the
    on-demand deep dive for a live process.  A window that recorded
    kernel launches but no device activity is taken again, up to
    ``WINDOW_RETAKES`` times; ``stats``, where given, receives the kept
    window's ``device_events`` and ``launches`` and the ``retakes``.
    Returns the log dir."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="bigdl_tpu_torch_profile_")
    for retake in range(WINDOW_RETAKES + 1):
        span = (tracer.span("torch_profiler_window", cat="profiler",
                            log_dir=log_dir, seconds=seconds)
                if tracer is not None else nullcontext())
        with span:
            with torch.profiler.profile(activities=_activities()) as prof:
                time.sleep(float(seconds))
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        device, launches = _device_counts(prof)
        if device or not launches:
            break
    if stats is not None:
        stats.update(device_events=device, launches=launches,
                     retakes=retake)
    _write_trace(prof, log_dir)
    return log_dir


def profile_step(step_fn, *args, log_dir: str, steps: int = 3,
                 tracer=None):
    """Run ``step_fn(*args)`` ``steps`` times under ``torch.profiler``
    (Chrome trace in ``<log_dir>/trace.json``), synchronizing the device
    after each step.  ``tracer``: an optional telemetry ``Tracer`` — the
    profiled region and each step also land as spans there (the span's
    ``log_dir`` arg points at the capture).  Returns the last output."""
    def span(name, **kw):
        return tracer.span(name, cat="profiler", **kw) if tracer \
            else nullcontext()

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    step_fn(*args)  # warm outside the capture
    sync()
    out = None
    with span("torch_profiler_trace", log_dir=log_dir, steps=steps):
        with torch.profiler.profile(activities=_activities()) as prof:
            for i in range(steps):
                with span("profiled_step", i=i):
                    out = step_fn(*args)
                    sync()
    _write_trace(prof, log_dir)
    return out
