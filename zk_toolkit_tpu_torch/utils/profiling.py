"""Timing on the card: named time spans for the stages of a run, the
per-call timers of chip_smoke.py, kernel_ab.py and kernel_variants.py, and
the JAX package's tracing hooks (zk_toolkit_tpu/utils/profiling.py):

- `Spans`: on a CUDA device each span records a pair of CUDA events on the
  current stream, so a span measures device time between its start and end
  without synchronising inside the run; `totals()` synchronises once and
  sums the milliseconds per name. On the CPU spans use the host clock.
- `timed(name)`: a host wall-clock span accumulating into a module-level
  table (`report()` reads it, `reset()` clears it).
- `trace(name)`: a torch.profiler trace of the span, written as a Chrome
  trace into $ZKT_PROFILE_DIR when that is set (CUDA activity too when a
  card is present), else a `timed` span.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch

log = logging.getLogger("zk_toolkit_tpu_torch.profiling")

_SPANS: dict[str, list[float]] = defaultdict(list)


class Spans:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._events = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._events[name].append((start, end))
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._events[name].append((t0, time.perf_counter()))

    def totals(self) -> dict[str, float]:
        """Milliseconds per span name, summed over its occurrences."""
        if self.cuda:
            torch.cuda.synchronize()
            return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self._events.items()}
        return {k: sum((e - s) * 1e3 for s, e in v) for k, v in self._events.items()}


# A spin on the card long enough to cover the host's enqueue of a timed run
# of small launches (about 50 ms at the H100's 1.98 GHz boost clock).
SLEEP_CYCLES = 100_000_000


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call of fn() over `reps` back-to-back calls,
    between CUDA events: the card's time where the card is the limit, the
    host's time per call where the host is."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int):
    """(device ms per call, host us per call) of fn(). The calls queue behind
    a spin on the card, so the events bracket the card's work alone and the
    host clock the enqueue alone; raises if the host took longer to enqueue
    them than the spin lasted. The spin is SLEEP_CYCLES, or up to 20 times
    longer where a first call's host time says the enqueue of `reps` calls
    may need it (a call of many launches)."""
    t0 = time.perf_counter()
    fn()
    first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(min(20 * SLEEP_CYCLES, max(SLEEP_CYCLES, int(4 * reps * first_s * 2e9))))
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError(f"enqueue of {reps} calls ({host_ms:.1f} ms) outlasted the spin")
    return ev[1].elapsed_time(ev[2]) / reps, host_ms * 1e3 / reps


@contextlib.contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _SPANS[name].append(dt)
        log.debug("span %s: %.4fs", name, dt)


@contextlib.contextmanager
def trace(name: str):
    """A torch.profiler trace of the span when ZKT_PROFILE_DIR is set,
    written to <dir>/<name>-<pid>-<n>.pt.trace.json (view it in Perfetto or
    chrome://tracing), as well as a timed() span; else a timed() span only."""
    from torch.profiler import ProfilerActivity, profile

    from zk_toolkit_tpu_torch.config import profile_dir

    d = profile_dir()
    if not d:
        with timed(name):
            yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(d, exist_ok=True)
    with profile(activities=activities) as prof, timed(name):
        yield
    path = os.path.join(d, f"{name}-{os.getpid()}-{len(_SPANS[name])}.pt.trace.json")
    prof.export_chrome_trace(path)
    log.debug("trace %s: %s", name, path)


def report() -> dict:
    """{span: {count, total_s, mean_s}} for all timed() spans so far."""
    return {
        k: {"count": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
        for k, v in _SPANS.items()
    }


def reset() -> None:
    _SPANS.clear()
