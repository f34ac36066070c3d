"""Every torch.profiler session of a ``chip_smoke.py`` run, counted.

Runs ``chip_smoke.main`` (its arguments are this script's) with a hook on
``torch.profiler.profile.__exit__`` that reads each finished session's
events: the device kernels it holds, the kernel launch calls it recorded,
the launches whose kernel it lost and how many of those came before the
first launch it kept, and the kernel-minus-launch start times.  A session
that lost a fifth of its launches or more is printed as it ends; all of
them go to ``chiprun_out/profiler_sessions_<TEARDOWN_CUPTI>.json`` (the
variable's value, ``default`` when unset) when the process exits.  Run on
the card from the repository root, once as is and once with
``TEARDOWN_CUPTI=0`` (CUPTI kept attached between sessions):

    python3 probes/profiler_sessions.py
    TEARDOWN_CUPTI=0 python3 probes/profiler_sessions.py
"""

from __future__ import annotations

import atexit
import json
import os
import statistics
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

T0 = time.monotonic()
SESSIONS = []
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
          "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def _start(e):
    return e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000


def record(prof):
    """Append the counts of one finished session to SESSIONS."""
    from torch.autograd import DeviceType
    ev = prof.profiler.kineto_results.events()
    ann = [getattr(e, "is_user_annotation", lambda: False)() for e in ev]
    kern = [e for e, a in zip(ev, ann) if e.device_type() == DeviceType.CUDA
            and not a and not e.name().startswith(("Memcpy", "Memset"))]
    launches = {e.correlation_id(): e for e in ev
                if e.device_type() == DeviceType.CPU and e.name() in LAUNCH}
    cpu = [_start(e) for e in ev if e.device_type() == DeviceType.CPU]
    deltas = [_start(k) - _start(launches[k.correlation_id()])
              for k in kern if k.correlation_id() in launches]
    got = {k.correlation_id() for k in kern}
    lost = [c for c in launches if c not in got]
    rec = {"t": round(time.monotonic() - T0, 2), "events": len(ev),
           "kernels": len(kern), "launch_calls": len(launches),
           "lost": len(lost),
           "cpu_span_ms": (max(cpu) - min(cpu)) / 1e6 if cpu else None,
           "gpu_minus_cpu_start_ms": (min(_start(k) for k in kern)
                                      - min(cpu)) / 1e6
           if kern and cpu else None,
           "delta_ms": [min(deltas) / 1e6, statistics.median(deltas) / 1e6,
                        max(deltas) / 1e6] if deltas else None}
    kept = [c for c in got if c in launches]
    if lost and kept:
        first_kept = min(_start(launches[c]) for c in kept)
        rec["lost_before_first_kept"] = sum(
            _start(launches[c]) < first_kept for c in lost)
    SESSIONS.append(rec)
    if rec["kernels"] == 0 or rec["lost"] > 0.2 * max(1, rec["launch_calls"]):
        print("profiler session", rec, flush=True)


_exit = torch.profiler.profile.__exit__


def _recording_exit(self, *exc):
    out = _exit(self, *exc)
    try:
        record(self)
    except Exception:  # the run goes on; the trace says what failed
        traceback.print_exc()
    return out


torch.profiler.profile.__exit__ = _recording_exit


def dump():
    os.makedirs("chiprun_out", exist_ok=True)
    path = (f"chiprun_out/profiler_sessions_"
            f"{os.environ.get('TEARDOWN_CUPTI', 'default')}.json")
    with open(path, "w") as f:
        json.dump(SESSIONS, f)
    print(f"profiler sessions: {len(SESSIONS)}, holding no kernel "
          f"{sum(s['kernels'] == 0 for s in SESSIONS)}, losing launches "
          f"{sum(s['lost'] > 0 for s in SESSIONS)}; {path}", flush=True)


if __name__ == "__main__":
    atexit.register(dump)
    import chip_smoke  # noqa: E402
    sys.exit(chip_smoke.main(sys.argv[1:]))
