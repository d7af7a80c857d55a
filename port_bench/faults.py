"""The control and the planted faults that `correct` must catch.

Each is a hook for a generator's "built" stage: `hook(ctx, system)`, where
system holds the pool's `nodes` and device ring `pipe`. They break the
program underneath the timed path, in this process only, and are used by
`port_bench.control` on the card and by the CPU tests; no benchmark run
sets them.
"""
from __future__ import annotations

import numpy as np

from port_bench.reference.ed25519 import L


class _Wrapped:
    """An Ed25519Verifier passing every call through, save those it
    overrides."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def verify_batch(self, items):
        return self.collect_batch(self.submit_batch(items), wait=True)


class ReduceS(_Wrapped):
    """S taken modulo L before staging: S + L twins verify."""

    def submit_batch(self, items):
        out = []
        for m, s, v in items:
            s = bytes(s)
            if len(s) == 64 and int.from_bytes(s[32:], "little") >= L:
                s = s[:32] + (int.from_bytes(s[32:], "little") % L) \
                    .to_bytes(32, "little")
            out.append((m, s, v))
        return self._inner.submit_batch(out)


class HalfBatch(_Wrapped):
    """Half of each wave left out: only the first half is verified, and
    the rest is answered as the verified half mostly reads."""

    def submit_batch(self, items):
        items = list(items)
        half = max(1, len(items) // 2)
        return (self._inner.submit_batch(items[:half]), len(items))

    def collect_batch(self, token, wait=True):
        tok, n = token
        got = self._inner.collect_batch(tok, wait=wait)
        if got is None:
            return None
        got = np.asarray(got, dtype=bool)
        rest = np.full(n - len(got), bool(got.mean() >= 0.5))
        return np.concatenate([got, rest])


class FlipOne(_Wrapped):
    """An answer altered where it is produced: the second verdict of
    every wave inverted (a padded wave's real items come first)."""

    def collect_batch(self, token, wait=True):
        got = self._inner.collect_batch(token, wait=wait)
        if got is None or len(got) < 2:
            return got
        got = np.asarray(got, dtype=bool).copy()
        got[1] = ~got[1]
        return got


def _wrap_verifier(system, cls) -> None:
    pipe = system["pipe"]
    pipe._ed_inner = cls(pipe._ed_inner)


def control(ctx, system) -> None:
    """The control: the program without its S < L screens, so that it
    accepts the malleable twin (S + L) of a signature, which RFC 8032
    section 5.1.7 refuses. The ring's screen is its module's bound."""
    from plenum_tpu_torch.parallel import pipeline
    ctx.restore.append((pipeline, "_ED_L", pipeline._ED_L))
    pipeline._ED_L = 1 << 256
    _wrap_verifier(system, ReduceS)


def state_unchanged(ctx, system) -> None:
    """The pool's NYMs applied without touching state."""
    from plenum_tpu_torch.execution.handlers.nym import NymHandler
    ctx.restore.append((NymHandler, "update_state", NymHandler.update_state))
    NymHandler.update_state = lambda self, txn, is_committed: None


def half_batch(ctx, system) -> None:
    _wrap_verifier(system, HalfBatch)


def flip_one(ctx, system) -> None:
    _wrap_verifier(system, FlipOne)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "flip_one": flip_one}
