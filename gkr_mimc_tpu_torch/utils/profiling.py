"""Timers and traces (the reference's gkr_mimc_tpu/utils/profiling.py).

* ``Timer`` / ``timed``: wall-clock phase timers; ``Timer.sync_on``
  names tensors whose devices are synchronised before the timer stops, so
  the kernels queued in a phase are charged to it. They print
  "<name> took <ms> ms", the reference's format.
* ``phase_report()``: the accumulated {phase: {total_ms, count, mean_ms}}.
* ``profile_trace(name)``: ``torch.profiler`` over the CPU and, when there
  is one, the card, writing a Chrome trace under profiling/<name>/ (view it
  in chrome://tracing or Perfetto). GKR_PROFILE=0 turns it into a no-op
  without touching call sites.

Nothing here runs unless entered: the prover pays nothing for it.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict

import torch

_PHASE_TOTALS: dict = defaultdict(float)
_PHASE_COUNTS: dict = defaultdict(int)


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a nest of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree)) if tree else set()
    return set()


class Timer:
    """Wall timer over a named phase, as a context manager. ``sync_on``
    tensors (a nest of them) are waited for before it stops."""

    def __init__(self, name: str, verbose: bool = True, out=None):
        self.name = name
        self.verbose = verbose
        self.out = out
        self.elapsed_ms: float | None = None
        self._sync = None

    def sync_on(self, tree):
        self._sync = tree
        return tree

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        for device in _cuda_devices(self._sync):
            torch.cuda.synchronize(device)
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        _PHASE_TOTALS[self.name] += self.elapsed_ms
        _PHASE_COUNTS[self.name] += 1
        if self.verbose and exc[0] is None:
            print(f"{self.name} took {self.elapsed_ms:.1f} ms", file=self.out or sys.stderr)
        return False


@contextlib.contextmanager
def timed(name: str, verbose: bool = True):
    with Timer(name, verbose=verbose) as t:
        yield t


def phase_report(reset: bool = False) -> dict:
    """Accumulated {phase: {total_ms, count, mean_ms}} over every Timer."""
    rep = {k: {"total_ms": v, "count": _PHASE_COUNTS[k], "mean_ms": v / _PHASE_COUNTS[k]}
           for k, v in _PHASE_TOTALS.items()}
    if reset:
        _PHASE_TOTALS.clear()
        _PHASE_COUNTS.clear()
    return rep


@contextlib.contextmanager
def profile_trace(name: str, root: str | None = None):
    """Trace the body with ``torch.profiler`` (CPU, and CUDA when a card
    is present) and write profiling/<name>/trace.json (under ``root``
    instead of the working directory if given); yields that path, or None
    when GKR_PROFILE=0."""
    if os.environ.get("GKR_PROFILE", "1") == "0":
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(root or os.path.join(os.getcwd(), "profiling"), name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    trace = os.path.join(path, "trace.json")
    with profile(activities=activities) as prof:
        yield trace
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
