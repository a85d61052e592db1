"""A `torch.profiler` trace of one window, reduced to what the per-layer
metrics read: the device operations inside the window (name, start, end,
correlation id), the window's wall time, the device's busy time (the union
of its operations' intervals), totals by kernel, and the idle gaps by what
the host was doing.

A trace is opened and closed by a sleep kernel and a host wait: the
profiler can drop kernels at a trace's edges.  The window is the host
range named `WINDOW` around the traced work, which ends in a device read.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict

WINDOW = "bench.window"
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def ident(name: str) -> str:
    """A kernel's function name without its return type, namespace,
    template arguments and parameters."""
    name = name.strip().replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.split("::")[-1].strip()


def capture(fn) -> list[dict]:
    """Run `fn()` under the profiler; its raw events as plain dicts."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            fn()
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()
        time.sleep(0.05)
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        dev = str(e.device_type()).endswith("CUDA")
        out.append({"name": e.name(), "kind": kind, "device": dev, "start": e.start_ns() * 1e-9,
                    "end": (e.start_ns() + e.duration_ns()) * 1e-9, "corr": int(e.correlation_id())})
    return out


def reduce(events: list[dict]) -> dict:
    """The window's device operations and the numbers read from them."""
    windows = [e for e in events if e["name"] == WINDOW and not e["device"]]
    if not windows:
        raise RuntimeError("the trace has no window range")
    w0, w1 = windows[0]["start"], windows[0]["end"]
    ops = sorted((e for e in events if e["device"] and e["name"] != WINDOW
                  and (e["kind"] in _DEVICE_KINDS or not e["kind"]) and w0 <= e["start"] and e["end"] <= w1),
                 key=lambda e: e["start"])
    busy, gaps, cur_end, prev = 0.0, [], w0, None
    for e in ops:
        if e["start"] > cur_end:
            gaps.append((cur_end, e["start"], prev, e))
        busy += max(0.0, e["end"] - max(e["start"], cur_end))
        if e["end"] > cur_end:
            cur_end, prev = e["end"], e
    if w1 > cur_end:
        gaps.append((cur_end, w1, prev, None))
    by_kernel, counts = defaultdict(float), defaultdict(int)
    for e in ops:
        by_kernel[ident(e["name"])] += e["end"] - e["start"]
        counts[ident(e["name"])] += 1
    host = [e for e in events if not e["device"] and e["name"] != WINDOW
            and (e["kind"] in _HOST_KINDS or not e["kind"]) and e["end"] >= w0 and e["start"] <= w1]
    idle = defaultdict(float)
    for g0, g1, before, after in gaps:
        if before is not None and after is not None and before["corr"] == after["corr"]:
            label = "inside one launch (graph nodes)"
        else:
            mid = (g0 + g1) / 2
            inner = [h for h in host if h["start"] <= mid <= h["end"]]
            label = "host: " + min(inner, key=lambda h: h["end"] - h["start"])["name"] if inner else "host: none"
        idle[label] += g1 - g0
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "window_s": w1 - w0, "busy_s": busy, "ops": [(ident(e["name"]), e["start"], e["end"]) for e in ops],
        "kernel_s": dict(by_kernel), "kernel_count": dict(counts),
        "breakdown": {"device_ops": top(by_kernel), "idle_gaps": top(idle)},
    }
