"""The card: finding it, naming it, and reading a profiler trace of it.

Nothing here falls back to the CPU: a run that finds fewer cards than its
cell asks for stops before it prints a result.
"""
from __future__ import annotations

import subprocess
import time
from contextlib import contextmanager, nullcontext

from port_bench.stats import union_seconds

# host ranges the harness opens around its calls into the program; the
# trace labels each idle gap of the card by the one that covers it most
SPAN_PREFIX = "pb."


class NoCard(Exception):
    """No CUDA device, or fewer than the cell asks for."""


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, "
                     f"torch sees {torch.cuda.device_count()}")


def _smi(query: str) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def info(n: int) -> dict:
    """The result line's `device`: what the run ran on."""
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n, "driver": _smi("driver_version"),
            "power_limit": _smi("power.limit"),
            "cuda": torch.version.cuda, "torch": torch.__version__,
            "torch_source": "cuda"}


def memory_peak_bytes(n: int) -> int:
    import torch
    return max(torch.cuda.max_memory_allocated(i) for i in range(n))


def span(name: str, trace):
    """A host span of the traced run, on any thread (a no-op untraced)."""
    if trace is None:
        return nullcontext()
    return trace.span(name)


class DeviceTrace:
    """torch.profiler over the card from start() to stop(), and the host
    spans the harness records meanwhile on the host clock (the
    profiler's own ranges cover only the thread that opened them)."""

    def __init__(self):
        self._prof = None
        self._range = None
        self.window_s = 0.0
        self._spans: list = []

    @contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self._spans.append((name, t, time.perf_counter()))

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._range = record_function(SPAN_PREFIX + "window")
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        """-> the trace's reading: busy_s (the union of every device
        operation), window_s, device seconds by operation name, and the
        longest idle gaps labelled by the host span that covers each
        most."""
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._range.__exit__(None, None, None)
        self._prof.stop()
        device = []
        w_start = w_end = None
        for ev in self._prof.events():
            if ev.name.startswith(SPAN_PREFIX):
                # the window's range; on the device timeline too, as a
                # user annotation, which is no device work
                if ev.name == SPAN_PREFIX + "window" and \
                        ev.device_type != DeviceType.CUDA:
                    w_start, w_end = ev.time_range.start, ev.time_range.end
            elif ev.device_type == DeviceType.CUDA:
                device.append((ev.name, ev.time_range.start,
                               ev.time_range.end))
        # host spans onto the trace's clock, anchored at the window's start
        base = w_start if w_start is not None else 0.0
        host = [(n, base + (a - self._t0) * 1e6, base + (b - self._t0) * 1e6)
                for n, a, b in self._spans]
        return reading(device, host, w_start, w_end, self.window_s)


def reading(device, host, w_start, w_end, window_s: float) -> dict:
    """Reduce device operations and host spans (name, start us, end us)
    to the run's trace figures; w_start/w_end bound the window in the
    trace's time, and set window_s where given (None: the extent of what
    was traced, window_s as measured on the host clock)."""
    if w_start is None:
        stamps = [t for _, s, e in device + host for t in (s, e)]
        w_start, w_end = (min(stamps), max(stamps)) if stamps else (0, 0)
    elif w_end > w_start:
        window_s = (w_end - w_start) / 1e6
    inside = [(n, max(s, w_start), min(e, w_end)) for n, s, e in device
              if e > w_start and s < w_end]
    by_name: dict[str, float] = {}
    for name, s, e in inside:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    busy_s = union_seconds([(s, e) for _, s, e in inside]) / 1e6
    gaps, reach = [], w_start
    for _, s, e in sorted(inside, key=lambda x: x[1]):
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    if w_end > reach:
        gaps.append((reach, w_end))
    # only the longest gaps are reported, so only they are labelled: a
    # window holds thousands of gaps and tens of thousands of host spans
    labelled = []
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        best, cover = "no host span", 0.0
        for name, s, e in host:
            c = min(e, ge) - max(s, gs)
            if c > cover:
                best, cover = name, c
        labelled.append((best, (ge - gs) / 1e6))
    return {"busy_s": busy_s, "window_s": window_s,
            "device_s_by_name": by_name,
            "device_ops": sorted(by_name.items(), key=lambda x: -x[1])[:10],
            "idle_gaps": labelled}
