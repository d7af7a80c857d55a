"""`StateCommitment` — the seam between ledger state and its commitment
scheme.

Everything above this interface (request handlers, the 3PC commit path,
the read plane, catchup cons-proofs, audit roots) talks to state through
one surface: write to the uncommitted head, promote/rewind heads by
root, read at any stored root, and produce/verify proofs against a
root *anchor* — an opaque 32-byte value the BLS multi-signature signs.
What the anchor commits to (an MPT root hash, a Verkle commitment
digest) is the backend's business, which is exactly what lets proof
formats, catchup cons-proofs, and ROADMAP item 4's root-pinned pruning
evolve independently of trie layout.

Backends register here; `make_state` is the one construction seam
(NodeBootstrap routes `Config.STATE_COMMITMENT` /
`STATE_COMMITMENT_PER_LEDGER` through it). MPT stays the default and
its wire format is byte-identical to the pre-interface code.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

BACKEND_MPT = "mpt"
BACKEND_VERKLE = "verkle"


class StateCommitment:
    """The interface contract (duck-typed; PruningState predates it and
    conforms structurally — the conformance test in
    tests/test_state_commitment.py is the enforcement, not isinstance).

    Surface, in the order the node exercises it:

    * writes: ``set(key, value)`` / ``remove(key)`` act on the
      uncommitted head;
    * heads: ``head_hash`` resolves and returns the uncommitted head's
      anchor; ``committed_head_hash`` the committed one; ``commit(root)``
      promotes; ``revert_to_head(root)`` rewinds the uncommitted head
      (3PC revert) — both O(1) by anchor;
    * reads: ``get(key, committed=...)``, ``get_for_root(key, root)``
      (historic), ``as_dict(committed=...)``;
    * proofs: ``generate_state_proof(key, root_hash=..., serialize=True)``
      -> bytes; ``batch_open(keys, root_hash=...)`` -> ONE aggregated
      proof blob answering the whole key page;
    * verification (static — clients hold no state):
      ``verify_state_proof(root, key, value, proof)`` and
      ``verify_batch_proof(root, entries, proof)`` with
      entries = [(key, value-or-None)]; both fail CLOSED (malformed
      proofs are False, never an exception);
    * plumbing: ``kv`` (the backing store, for the group-commit scope)
      and ``close()``.

    ``BACKEND`` names the scheme; the read plane uses it to pick the
    envelope kind, and `commitment_backend_of` is the one accessor.
    """

    BACKEND: str = BACKEND_MPT


def commitment_backend_of(state) -> str:
    """The scheme a state instance implements ("mpt" for pre-interface
    PruningState instances with no marker)."""
    return getattr(state, "BACKEND", BACKEND_MPT)


_BACKENDS: dict[str, Callable] = {}


def register_backend(name: str, factory: Callable) -> None:
    _BACKENDS[name] = factory


def make_state(backend: str = BACKEND_MPT, db=None, *,
               width: Optional[int] = None, pipeline=None):
    """Construct a state for one ledger.

    backend: "mpt" | "verkle" (the per-ledger config value).
    width: Verkle branching factor (ignored by MPT).
    pipeline: optional CryptoPipeline — the Verkle backend stages its
    batch commitment updates and proof generation as commitment waves.
    """
    # import-time registration without import cycles
    if not _BACKENDS:
        from . import mpt, verkle  # noqa: F401
    factory = _BACKENDS.get(backend)
    if factory is None:
        raise ValueError(f"unknown state commitment backend {backend!r} "
                         f"(have {sorted(_BACKENDS)})")
    return factory(db=db, width=width, pipeline=pipeline)


def backend_for_ledger(ledger_id: int, default: str,
                       per_ledger: Optional[dict] = None) -> str:
    """Resolve the per-ledger commitment choice: an explicit ledger entry
    wins, else the pool-wide default. Keys may arrive as ints or strings
    (config files)."""
    if per_ledger:
        for key in (ledger_id, str(ledger_id)):
            if key in per_ledger:
                return per_ledger[key]
    return default
