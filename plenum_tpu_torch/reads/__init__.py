"""Verified read plane: single-reply state-proof reads.

A read answered by ONE node is trustworthy when the reply carries a proof
anchored to a BLS multi-signed root: an MPT state proof against the signed
state root for trie-backed queries (or ONE aggregated Verkle multi-key
opening on wide-commitment ledgers — state/commitment/, the ``verkle``
envelope kind), an RFC-6962 inclusion proof against the
signed txn root for GET_TXN. The server half (ReadPlane) wraps every
ReadRequestManager result in that envelope and caches results per signed
root; the client half (VerifyingReadClient / SimReadDriver) sends each read
to one node, verifies proof + multi-sig + freshness, and fails over — only
proofless replies escalate to the legacy f+1 broadcast. See docs/reads.md.
"""
from .proofs import (READ_PROOF, result_core, result_digest,
                     verify_read_proof)
from .plane import ReadPlane
from .client import ReadCheck, ReadClientStats, SimReadDriver, \
    VerifyingReadClient
from .edge import EDGE_CANNOT_SERVE, EdgeCache, EdgeFleet, SimEdge

__all__ = ["EDGE_CANNOT_SERVE", "EdgeCache", "EdgeFleet", "READ_PROOF",
           "ReadPlane", "ReadCheck", "ReadClientStats", "SimEdge",
           "SimReadDriver", "VerifyingReadClient", "result_core",
           "result_digest", "verify_read_proof"]
