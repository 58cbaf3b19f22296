"""Named time spans for the stages of a run.

On a CUDA device each span records a pair of CUDA events on the current
stream, so a span measures device time between its start and end without
synchronising inside the run; `totals()` synchronises once and sums the
milliseconds per name. On the CPU spans use the host clock.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


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
