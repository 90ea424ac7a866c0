"""What a traced run records, from the benchmark's own code.

- Spans around the program's public module functions
  ``repro_torch.serving.engine.prefill`` and ``.decode_step``, which the
  engine looks up at call time, with a synchronise at each end.
- The calls of each kernel that a per-layer metric names (its
  ``portbench/counts/<kernel>.py``), with their operands' shapes, while
  the profiler runs.
- ``torch.profiler`` (CUDA activity only) over a bounded stretch of the
  window, started and stopped between two tokens from the token-time
  hook, at a share of the window's tokens; a marker kernel launched after
  a synchronise ties the device's clock to the host's.

Nothing here is installed in an untraced run.
"""
from __future__ import annotations

import importlib
import time
from typing import Dict, List, Optional, Tuple


class Spans:
    """(name, start, end, info) of each call of the wrapped functions."""

    def __init__(self, sync):
        self.sync = sync
        self.records: List[Tuple[str, float, float, Dict]] = []
        self._undo = []

    def wrap(self, module_name: str, fn_name: str, span: str, info):
        mod = importlib.import_module(module_name)
        orig = getattr(mod, fn_name)

        def wrapped(*args, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            self.sync()
            self.records.append((span, t0, time.perf_counter(), info(args, kw)))
            return out

        setattr(mod, fn_name, wrapped)
        self._undo.append((mod, fn_name, orig))

    def close(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo.clear()


class KernelCalls:
    """Bytes of each call of the named kernels while ``active``."""

    def __init__(self):
        self.active = False
        self.calls: Dict[str, List[int]] = {}
        self.counts = {}
        self._undo = []

    def wrap(self, kernel: str):
        counts = importlib.import_module(f"portbench.counts.{kernel}")
        self.counts[kernel] = counts
        self.calls.setdefault(kernel, [])
        mod = importlib.import_module(counts.MODULE)
        orig = getattr(mod, counts.FUNCTION)

        def wrapped(*args, **kw):
            if self.active:
                self.calls[kernel].append(counts.call_bytes(args))
            return orig(*args, **kw)

        setattr(mod, counts.FUNCTION, wrapped)
        self._undo.append((mod, counts.FUNCTION, orig))

    def close(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo.clear()


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, duration ns) of every device activity recorded."""
    from torch.autograd import DeviceType

    try:
        evs = prof.profiler.kineto_results.events()
        return [(e.name(), int(e.start_ns()), int(e.duration_ns())) for e in evs
                if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        return [(e.name, int(e.time_range.start * 1000), int(e.time_range.elapsed_us() * 1000))
                for e in prof.events() if e.device_type == DeviceType.CUDA]


class Stretch:
    """The profiler over ``seconds`` of the window from the
    ``start_token``-th token served (or to the window's end), with the
    kernel calls recorded over the same stretch. Counting tokens, not
    seconds, keeps the stretch at the same point of the work however fast
    the program serves it."""

    def __init__(self, start_token: int, seconds: float, calls: KernelCalls, device):
        self.start_token, self.seconds = start_token, seconds
        self.tokens = 0
        self.calls, self.device = calls, device
        self.state = "waiting"
        self.prof = None
        self.t0 = self.t1 = None          # host perf_counter of the stretch's ends
        self.events: List[Tuple[str, int, int]] = []

    @staticmethod
    def warm(device):
        """Start and stop the profiler once in set-up: its first start
        loads CUPTI, which would otherwise land in the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def tick(self, now: float):
        """Called at each token served."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.tokens += 1
        if self.state == "waiting" and self.tokens >= self.start_token:
            torch.cuda.synchronize(self.device)
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize(self.device)
            self.t0 = time.perf_counter()
            torch.ones(1, device=self.device).fill_(0.0)     # the marker
            self.calls.active = True
            self.state = "on"
        elif self.state == "on" and now - self.t0 >= self.seconds:
            self.stop()

    def stop(self):
        import torch

        if self.state != "on":
            return
        self.calls.active = False
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.events = sorted(_device_events(self.prof), key=lambda e: e[1])
        self.prof = None
        self.state = "done"

    def summary(self, spans: Spans) -> Optional[Dict]:
        """Busy seconds (the union of device intervals), the stretch's
        length, device seconds and launches by kernel name, and the idle
        gaps labelled by what the host was doing (a span's name, or the
        engine's own loop outside every span)."""
        if self.state != "done" or not self.events:
            return None
        marker = self.events[0]
        offset = marker[1] - int(self.t0 * 1e9)            # device ns - host ns
        lo, hi = marker[1], int(self.t1 * 1e9) + offset
        busy, by_name = 0, {}
        merged: List[List[int]] = []
        for name, start, dur in self.events[1:]:
            end = start + dur
            if end <= lo or start >= hi:
                continue
            tot, n = by_name.get(name, (0, 0))
            by_name[name] = (tot + dur, n + 1)
            start, end = max(start, lo), min(end, hi)
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        busy = sum(e - s for s, e in merged)
        host = [(n, int(a * 1e9) + offset, int(b * 1e9) + offset)
                for n, a, b, _ in spans.records]
        gaps = []
        prev = lo
        for s, e in merged + [[hi, hi]]:
            if s > prev:
                mid = (prev + s) // 2
                label = next((n for n, a, b in host if a <= mid < b), "engine loop")
                gaps.append((label, (s - prev) / 1e9))
            prev = max(prev, e)
        return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
                "kernels": {k: (t / 1e9, n) for k, (t, n) in by_name.items()},
                "gaps": gaps}
