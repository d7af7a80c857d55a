"""The crypto host as the benchmark runs it.

    python3 -m port_bench.svc_host --report PATH [--trace] [--wrap NAME] \
        -- <crypto_service arguments>

The port's `parallel/crypto_service.main`, with what the benchmark adds in
this process alone and never in the program:

- SIGUSR1 opens the measured window and SIGUSR2 closes it. At the close
  this process writes its report to PATH (JSON, replaced whole): the
  card's memory peak and, with --trace, the window's device trace reduced
  here (`port_bench.device.reading`: busy union, device seconds by
  operation, the top operations and idle gaps) and the program's host-span
  session (`common/host_spans.RECORDER`, enabled over the window).
- The trace is a `torch.profiler` session of CUDA activity only, set up
  once the service has bound its socket (PATH.ready says when: setting
  up CUPTI takes seconds, which the window must not hold), started and
  stopped at the window's edges: a few device operations a dispatch,
  reduced in seconds, never shipped raw.
- --wrap NAME puts `port_bench.faults.NAME` around the service's
  verifier (the control: ReduceS, S taken modulo L before staging).

Both signals are blocked in every thread and taken by one thread of this
module (`sigwait`), so neither interrupts the service's own threads.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

SIGNALS = {signal.SIGUSR1, signal.SIGUSR2}


def _patch_factory(wraps) -> None:
    """crypto_service.main builds its verifier with make_verifier: the
    faults named by --wrap go around what it returns."""
    from plenum_tpu_torch.crypto import ed25519
    from port_bench import faults
    made = ed25519.make_verifier

    def make_verifier(*a, **kw):
        v = made(*a, **kw)
        for name in wraps:
            v = getattr(faults, name)(v)
        return v
    ed25519.make_verifier = make_verifier


class Window:
    """What SIGUSR1 and SIGUSR2 open and close."""

    def __init__(self, report: str, trace: bool):
        self.report, self.trace = report, trace
        self._prof = None
        self._t0 = None
        self.times: dict[str, float] = {}

    def ready(self, sock: str) -> None:
        """Once the service has bound `sock`: set the profiler up (traced),
        then write PATH.ready."""
        while not os.path.exists(sock):
            time.sleep(0.05)
        if self.trace:
            import torch
            if torch.cuda.is_available():
                from torch.profiler import ProfilerActivity, profile
                t = time.perf_counter()
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.prepare_trace()
                self.times["prepare_s"] = time.perf_counter() - t
        _write(self.report + ".ready", self.times)

    def _recorder(self):
        try:
            from plenum_tpu_torch.common.host_spans import RECORDER
        except ImportError:
            return None
        return RECORDER

    def open(self) -> None:
        t = self._t0 = time.perf_counter()
        if not self.trace:
            return
        if self._prof is not None:
            self._prof.start_trace()
        rec = self._recorder()
        if rec is not None:
            rec.enable()
        self._t0 = time.perf_counter()
        self.times["open_s"] = self._t0 - t

    def close(self) -> None:
        import torch
        out = {"memory_peak_bytes": 0, "trace": None, "session": None}
        on_card = torch.cuda.is_available()
        if self.trace and self._t0 is not None:
            if on_card:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - self._t0
            rec = self._recorder()
            if rec is not None:
                rec.disable()
                out["session"] = rec.session()
            out["window_s"] = window_s
            if self._prof is not None:
                out["trace"] = reduce(self._prof, window_s)
                self._prof = None
        if on_card:
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(0)
        out["times"] = self.times
        _write(self.report, out)


def _write(path: str, obj) -> None:
    """JSON, replaced whole."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def reduce(prof, window_s: float) -> dict:
    """Stop a CUDA-only profiler session and reduce it here to the trace
    figures (`port_bench.device.reading`): every device operation it
    recorded lies inside the window, so the window is the host clock's."""
    from torch.autograd import DeviceType

    from port_bench import device
    t = time.perf_counter()
    prof.stop()
    ops = [(ev.name, ev.time_range.start, ev.time_range.end)
           for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    out = device.reading(ops, [], None, None, window_s)
    out["device_ops_n"] = len(ops)
    out["reduce_s"] = time.perf_counter() - t
    return out


def _serve_signals(window: Window, sock: str) -> None:
    window.ready(sock)
    while True:
        sig = signal.sigwait(SIGNALS)
        try:
            window.open() if sig == signal.SIGUSR1 else window.close()
        except Exception as exc:          # reported, never fatal to the host
            print(f"svc_host: window {sig}: {type(exc).__name__}: {exc}",
                  file=sys.stderr, flush=True)


def main(argv=None) -> None:
    # first, before any thread exists: every thread inherits the mask
    signal.pthread_sigmask(signal.SIG_BLOCK, SIGNALS)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", required=True)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--wrap", action="append", default=[])
    ap.add_argument("service", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    service = args.service[1:] if args.service[:1] == ["--"] \
        else args.service
    if args.wrap:
        _patch_factory(args.wrap)
    window = Window(args.report, args.trace)
    sock = service[service.index("--socket") + 1]
    threading.Thread(target=_serve_signals, args=(window, sock),
                     daemon=True, name="svc_host.window").start()
    from plenum_tpu_torch.parallel import crypto_service
    crypto_service.main(service)


if __name__ == "__main__":
    main()
