"""MPT backend of the `StateCommitment` interface — the default.

`PruningState` (state/pruning_state.py) predates the interface and
already conforms structurally; this module adds the interface extras —
the `BACKEND` marker and page-granular `batch_open` /
`verify_batch_proof` — directly onto it (registered here so importing
the commitment package is what activates the seam; the class itself
stays where every existing import expects it).

MPT has no aggregation: a page's batch proof is simply the list of
per-key sibling chains, each independently verifiable. That is the
honest baseline the Verkle A/B (config13) measures against — the
interface intentionally does NOT pretend MPT pages are cheaper than
k singles.
"""
from __future__ import annotations

from typing import Optional, Sequence

from plenum_tpu_torch.common.serialization import pack, unpack
from plenum_tpu_torch.state.pruning_state import PruningState

from .base import BACKEND_MPT, register_backend


def _batch_open(self, keys: Sequence[bytes],
                root_hash: Optional[bytes] = None) -> dict:
    """A page of per-key MPT proofs under one root: {"proofs": [rlp...]}.
    O(k log n) bytes — the baseline the Verkle aggregation beats."""
    root = root_hash if root_hash is not None else self.committed_head_hash
    return {"proofs": [self.generate_state_proof(k, root_hash=root,
                                                 serialize=True)
                       for k in keys]}


def _verify_batch_proof(root_hash: bytes, entries: Sequence[tuple],
                        proof) -> bool:
    try:
        if isinstance(proof, (bytes, bytearray)):
            proof = unpack(bytes(proof))
        chains = proof["proofs"]
        if len(chains) != len(entries):
            return False
        return all(
            PruningState.verify_state_proof(root_hash, bytes(k), v, p)
            for (k, v), p in zip(entries, chains))
    except Exception:
        return False


# interface extras, attached once at import
if not hasattr(PruningState, "batch_open"):
    PruningState.BACKEND = BACKEND_MPT
    PruningState.batch_open = _batch_open
    PruningState.verify_batch_proof = staticmethod(_verify_batch_proof)


def _factory(db=None, width=None, pipeline=None):
    return PruningState(db, pipeline=pipeline)


_factory._cls = PruningState
register_backend(BACKEND_MPT, _factory)
