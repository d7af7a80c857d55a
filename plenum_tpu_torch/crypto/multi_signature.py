"""Multi-signature value types.

Reference behavior: crypto/bls/bls_multi_signature.py — MultiSignatureValue is
the canonical tuple every node BLS-signs at COMMIT time (ledger id, state root,
pool state root, txn root, timestamp); MultiSignature pairs the aggregated
signature with the participant list and the signed value. Serialized into
PRE-PREPARE (bls_multi_sig field) and the BlsStore keyed by state root.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Sequence, Union

from plenum_tpu_torch.common.serialization import signing_serialize


class MultiSignatureValue(NamedTuple):
    ledger_id: int
    state_root_hash: str
    pool_state_root_hash: str
    txn_root_hash: str
    timestamp: float

    def as_single_value(self) -> bytes:
        """Canonical bytes that get BLS-signed (ref as_single_value)."""
        return signing_serialize({
            "ledger_id": self.ledger_id,
            "state_root_hash": self.state_root_hash,
            "pool_state_root_hash": self.pool_state_root_hash,
            "txn_root_hash": self.txn_root_hash,
            "timestamp": self.timestamp,
        })

    def to_list(self) -> list:
        return [self.ledger_id, self.state_root_hash, self.pool_state_root_hash,
                self.txn_root_hash, self.timestamp]

    @classmethod
    def from_list(cls, items: Sequence) -> "MultiSignatureValue":
        return cls(int(items[0]), str(items[1]), str(items[2]), str(items[3]),
                   float(items[4]))


class MultiSignature(NamedTuple):
    signature: str                     # aggregated BLS sig (base58)
    participants: tuple[str, ...]      # node names whose sigs were aggregated
    value: MultiSignatureValue

    def to_list(self) -> list:
        return [self.signature, list(self.participants), self.value.to_list()]

    @classmethod
    def from_list(cls, items: Sequence) -> "MultiSignature":
        return cls(str(items[0]), tuple(items[1]),
                   MultiSignatureValue.from_list(items[2]))

    def verify(self,
               bls_keys: Union[Mapping[str, str],
                               Callable[[str], Optional[str]]],
               n: Optional[int] = None) -> bool:
        """THE shared verification path for a multi-signature value —
        server (PRE-PREPARE validation fast path aside) and verifying
        read clients both judge a sig by exactly this rule set:

        - participants are DISTINCT (plain point addition means one
          colluding signer repeated n-f times would otherwise verify as
          a quorum — rogue self-aggregation);
        - every participant resolves to a known BLS verkey;
        - the participant count reaches the n-f signature quorum of an
          n-node pool (n defaults to the key-register size);
        - the aggregated signature verifies over the CANONICAL value
          serialization (as_single_value) under the aggregated keys.

        Never raises: unknown names, malformed keys/sigs -> False.
        """
        participants = self.participants
        if not participants or \
                len(set(participants)) != len(participants):
            return False
        lookup = bls_keys.get if isinstance(bls_keys, Mapping) \
            else bls_keys
        try:
            verkeys = [lookup(name) for name in participants]
        except Exception:
            return False
        if any(vk is None for vk in verkeys):
            return False
        if n is not None:
            pool_n = n
        elif isinstance(bls_keys, Mapping):
            pool_n = len(bls_keys)
        else:
            return False     # callable lookup can't imply the pool size
        from plenum_tpu_torch.common.quorums import Quorums
        if not Quorums(pool_n).bls_signatures.is_reached(len(participants)):
            return False
        from plenum_tpu_torch.crypto import bls as bls_lib
        try:
            return bls_lib.verify_multi_sig(
                self.signature, self.value.as_single_value(), verkeys)
        except Exception:
            return False
