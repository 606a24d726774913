"""Profiling and step-timing hooks, counterpart of
``tlie_tpu/utils/profiling.py`` on ``torch.profiler``:

- :func:`profile_trace` records the enclosed region (host ops, CUDA kernels
  where a card is present) and exports a Chrome trace,
  ``log_dir/trace-<pid>-<n>.json``, viewable in Perfetto or
  ``chrome://tracing``;
- :class:`StepTimer` is the rolling steps/s tracker;
- :func:`annotate` names a region of the trace
  (``torch.profiler.record_function``).

A trace that cannot start (a profiler already running, a runtime without
CUPTI) prints why and the region runs untraced, as ``tlie_tpu``'s does.
That is the only guarded call: the region itself, kernels included, runs
unguarded, and its errors propagate.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Iterator

import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def profile_trace(log_dir: str = "./profiles") -> Iterator[None]:
    """Trace the enclosed region into a Chrome trace under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    started = False
    if torch._C._autograd._profiler_enabled():
        # a second profiler started inside a running one would stop it at its exit
        print("[profiling] trace unavailable (a profiler is already running)")
    else:
        try:
            prof.__enter__()
            started = True
        except RuntimeError as exc:  # a runtime that cannot trace
            print(f"[profiling] trace unavailable ({exc})")
    try:
        yield
    finally:
        if started:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_TRACES)}.json")
            prof.export_chrome_trace(path)
            print(f"[profiling] trace written to {path}")


class StepTimer:
    """Rolling steps/s: each :meth:`rate` is the steps since the last call
    over the seconds since it; the first window (which holds the warm-up)
    is flagged by ``first_window`` until then."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self._steps0 = 0
        self.first_window = True

    def rate(self, step: int) -> float:
        now = time.perf_counter()
        rate = (step - self._steps0) / max(now - self._t0, 1e-9)
        self._t0, self._steps0 = now, step
        self.first_window = False
        return rate


def annotate(name: str):
    """A named region of the trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
