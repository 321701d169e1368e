"""The device trace of a run, reduced to what the per-layer metrics read.

``torch.profiler`` (CUPTI on the card) records the window with host and
device activity. ``summarize`` keeps, in microseconds on the trace's
clock: the window (the benchmark's own ``bench_h100.window`` range), every
device operation (kernels, copies and sets) and the host operations on the
thread that ran the window. The arithmetic below follows the repository's
layer profile (device time summed over device events only, so an aten op
and the kernel it launched count once; busy share of the window; launch
counts).
"""

from __future__ import annotations

import contextlib

WINDOW = "bench_h100.window"
NOT_KERNELS = ("Memcpy", "Memset")  # device operations that are no kernel launch


def profiler(enabled: bool):
    """A CPU + CUDA profiler context, or a context that does nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def window_range():
    from torch.profiler import record_function

    return record_function(WINDOW)


def summarize(prof, proofs: int) -> dict:
    """-> {"window_us": [start, end], "proofs": n, "device": [[name, start, dur]],
    "host": [[name, start, end]]}, times in µs. Reads the profiler's raw
    events (building its event tree would take minutes for a window's
    million events); the device side of a ``record_function`` range (a user
    annotation) is no device operation and is left out."""
    rows = []
    for e in prof.profiler.kineto_results.events():
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device and (e.name() == WINDOW or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        rows.append((e.name(), on_device, e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
    windows = [r for r in rows if r[0] == WINDOW and not r[1]]
    if not windows:
        raise RuntimeError("the profiler recorded no window range")
    _, _, lo, hi, thread = windows[0]
    device = [[name, (s - lo) / 1e3, (e - s) / 1e3] for name, dev, s, e, _ in rows if dev]
    host = [[name, (s - lo) / 1e3, (e - lo) / 1e3] for name, dev, s, e, t in rows
            if not dev and t == thread and name != WINDOW]
    return {"window_us": [0.0, (hi - lo) / 1e3], "proofs": proofs, "device": device, "host": host}


def is_kernel(name: str) -> bool:
    return not name.startswith(NOT_KERNELS)


def busy_intervals(trace: dict) -> list:
    """The union of device operations, clipped to the window: [[start, end]] sorted."""
    lo, hi = trace["window_us"]
    spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d in trace["device"] if s < hi and s + d > lo)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(trace: dict) -> float:
    return sum(e - s for s, e in busy_intervals(trace))


def idle_gaps(trace: dict) -> list:
    """The window's stretches with no device operation: [[start, end]]."""
    lo, hi = trace["window_us"]
    gaps, t = [], lo
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append([t, s])
        t = max(t, e)
    if hi > t:
        gaps.append([t, hi])
    return gaps


def gap_causes(trace: dict) -> dict:
    """Idle µs by what the host was doing: the innermost host operation
    that covers each gap's midpoint ("host python" where none does)."""
    host = sorted(trace["host"], key=lambda h: (h[1], -h[2]))
    out: dict = {}
    stack, i = [], 0
    for s, e in idle_gaps(trace):
        mid = (s + e) / 2
        while i < len(host) and host[i][1] <= mid:
            stack.append(host[i])
            i += 1
        stack = [h for h in stack if h[2] >= mid]
        name = stack[-1][0] if stack else "host python"
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by host
    activity, in seconds, at most ``top`` of each."""
    ops: dict = {}
    for name, _, dur in trace["device"]:
        ops[name] = ops.get(name, 0.0) + dur
    rank = lambda d: sorted(([k[:200], v / 1e6] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(gap_causes(trace))}
