"""Fused commit wave: one dispatch cadence advancing every root the
ordered path must mint — the state-commitment head (MPT or Verkle), the
ledger tree append, and the audit ledger append.

Before this, the commit drain resolved each root INLINE: per-node
sha3/RLP in the MPT, per-level engine commits in the Verkle tree, and a
separate shadow-tree extend per ledger — each its own host loop, each
replica paying it again even when co-hosted replicas were minting the
exact same roots from the exact same ordered batch. The MTU design
(PAPERS.md) fuses tree level sweeps into one deep-pipelined program;
this module is the host-side orchestration half of that: every root
producer becomes a *family generator* that yields level-structured cmt
jobs instead of hashing inline, and the wave trampolines all families
in lockstep so each tree level across ALL families lands in ONE
`KIND_CMT` flush (pow-2 bucketed, prewarm/pin-enforced, cross-replica
deduped — parallel/pipeline.py `_flush_cmt`).

Family protocol (state/trie.py `resolve_root_staged`,
state/commitment/verkle.py `recommit_staged`, ledger/ledger.py
`uncommitted_root_staged`):

    gen = family()
    jobs = next(gen)              # one LIST of cmt jobs per level
    jobs = gen.send(results)      # aligned results back, next level out
    ...                           # StopIteration.value = the root

Degrade contract (the per-lane breaker story, docs/robustness.md): a
failed submit runs that family's level on the host engine; a per-job
None result (wedged engine past the pipeline's own degrade) is
host-recomputed job-by-job. Either way the root still advances and
`cmt_host_fallbacks` counts the event — ordering never stalls on a sick
commit lane, and the caller's outer fallback (execution/write_manager)
covers even a coordinator-level failure by resolving every root on the
plain host path, which stays byte-identical by construction.
"""
from __future__ import annotations

from typing import Optional

from plenum_tpu_torch.common import tracing


class _Family:
    __slots__ = ("name", "gen", "jobs", "root", "done")

    def __init__(self, name: str, gen):
        self.name = name
        self.gen = gen
        self.jobs = None
        self.root = None
        self.done = False


class CommitWave:
    """One ordered batch's triple-root drain. `add()` families, then
    `run()`; add more and `run()` again for phased drains (the audit
    txn can only be BUILT after the state/ledger roots resolve, so the
    executor runs phase A, builds the audit txn, then runs the audit
    ledger as phase B on the same wave object — both phases count as
    one wave in the stats)."""

    def __init__(self, pipeline, tracer=None, now=None):
        self._pipeline = pipeline
        self._tracer = (tracer if tracer is not None
                        else getattr(pipeline, "tracer", None)) \
            or tracing.NULL_TRACER
        self._now = now or getattr(pipeline, "_now", None)
        self._families: list[_Family] = []
        self._counted = False
        self.roots: dict[str, object] = {}

    def add(self, name: str, gen) -> None:
        """Register a family generator; a family whose tree is already
        clean returns without yielding and resolves immediately."""
        fam = _Family(name, gen)
        try:
            fam.jobs = next(gen)
        except StopIteration as e:
            fam.root, fam.done = e.value, True
            self.roots[name] = e.value
        self._families.append(fam)

    def run(self) -> dict:
        """Trampoline every pending family to completion, one fused cmt
        flush per level round. Returns {name: root} for ALL families
        added so far (earlier phases included)."""
        stats = getattr(self._pipeline, "stats", None)
        if not self._counted and any(not f.done for f in self._families):
            self._counted = True
            if stats is not None:
                stats["cmt_waves"] = stats.get("cmt_waves", 0) + 1
        while True:
            active = [f for f in self._families if not f.done]
            if not active:
                return dict(self.roots)
            t0 = self._now() if self._now is not None else None
            tokens = []
            n_jobs = 0
            for fam in active:
                n_jobs += len(fam.jobs)
                try:
                    tokens.append(
                        self._pipeline.submit_commitment(fam.jobs))
                except Exception:
                    tokens.append(None)    # host-run below
            if stats is not None:
                stats["cmt_levels"] = stats.get("cmt_levels", 0) + 1
            # first collect flushes the WHOLE staged level — every
            # family's jobs ride one `_flush_cmt` (the fused dispatch);
            # later collects read already-resolved tokens
            for fam, tok in zip(active, tokens):
                results = None
                if tok is not None:
                    try:
                        results = self._pipeline.collect_commitment(tok)
                    except Exception:
                        results = None
                results = self._patch(fam.jobs, results, stats)
                try:
                    fam.jobs = fam.gen.send(results)
                except StopIteration as e:
                    fam.root, fam.done = e.value, True
                    self.roots[fam.name] = e.value
            if self._tracer.enabled and t0 is not None:
                self._tracer.emit(tracing.DEVICE, "", {
                    "kind": "cmt", "n": n_jobs,
                    "families": len(active),
                    "dispatch": round(self._now() - t0, 9),
                })

    def _patch(self, jobs, results, stats) -> list:
        """Aligned, None-free results for one family's level: a failed
        submit or a per-job None degrades THAT job to the host engine
        (per-lane breaker isolation — the rest of the level keeps its
        wave results)."""
        if results is None:
            results = [None] * len(jobs)
        out = []
        for job, res in zip(jobs, results):
            if res is None:
                if stats is not None:
                    stats["cmt_host_fallbacks"] = \
                        stats.get("cmt_host_fallbacks", 0) + 1
                res = self._pipeline._cmt_run([job])[0]
            out.append(res)
        return out
