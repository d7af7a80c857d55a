"""State commitment subsystem: one interface, pluggable schemes.

See docs/state_commitment.md. `make_state` is the construction seam
(NodeBootstrap routes Config.STATE_COMMITMENT through it); MPT is the
default backend, Verkle the wide-branching aggregated-proof option.
"""
from .base import (BACKEND_MPT, BACKEND_VERKLE, StateCommitment,
                   backend_for_ledger, commitment_backend_of, make_state,
                   register_backend)
from .kzg import KzgEngine, engine_for
from .mpt import PruningState  # noqa: F401  (registers the mpt backend)
from .verkle import DEFAULT_WIDTH, VerkleState, anchor_of, stem_of

__all__ = ["BACKEND_MPT", "BACKEND_VERKLE", "StateCommitment",
           "backend_for_ledger", "commitment_backend_of", "make_state",
           "register_backend", "KzgEngine", "engine_for", "VerkleState",
           "DEFAULT_WIDTH", "anchor_of", "stem_of"]
