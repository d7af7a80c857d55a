"""Node bootstrap: storages, ledgers, states, handlers, managers, BLS, authN.

Reference behavior: plenum/server/node_bootstrap.py:17 + ledgers_bootstrap.py —
build the 4 base ledgers in catchup order (audit, pool, config, domain,
node.py:142), a state trie per non-audit ledger, register request + batch
handlers, wire BLS, and replay committed txns into state so a restarted (or
genesis-seeded) node starts from consistent roots.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

from plenum_tpu_torch.common.node_messages import (AUDIT_LEDGER_ID,
                                                   CONFIG_LEDGER_ID,
                                                   DOMAIN_LEDGER_ID, POOL_LEDGER_ID)
from plenum_tpu_torch.consensus.bls_bft_replica import (BlsBftReplica, BlsKeyRegister,
                                                        BlsStore)
from plenum_tpu_torch.crypto.bls import BlsCryptoSigner, BlsCryptoVerifier
from plenum_tpu_torch.crypto.ed25519 import make_verifier
from plenum_tpu_torch.execution import (DatabaseManager, LedgerBatchExecutor,
                                        ReadRequestManager, WriteRequestManager)
from plenum_tpu_torch.execution.database_manager import (BLS_STORE_LABEL,
                                                         NODE_STATUS_DB_LABEL,
                                                         SEQ_NO_DB_LABEL,
                                                         TS_STORE_LABEL)
from plenum_tpu_torch.execution.handlers import (GetFrozenLedgersHandler,
                                                 GetNymHandler,
                                                 GetTxnAuthorAgreementAmlHandler,
                                                 GetTxnAuthorAgreementHandler,
                                                 GetTxnHandler, LedgersFreezeHandler,
                                                 NodeHandler, NymHandler,
                                                 TxnAuthorAgreementAmlHandler,
                                                 TxnAuthorAgreementDisableHandler,
                                                 TxnAuthorAgreementHandler)
from plenum_tpu_torch.execution.txn import NODE, NYM
from plenum_tpu_torch.execution import txn as txn_lib
from plenum_tpu_torch.storage.state_ts_store import StateTsStore
from plenum_tpu_torch.ledger.compact_merkle_tree import CompactMerkleTree
from plenum_tpu_torch.ledger.hash_store import HashStore
from plenum_tpu_torch.ledger.ledger import Ledger
from plenum_tpu_torch.ledger.tree_hasher import make_tree_hasher
from plenum_tpu_torch.node.client_authn import CoreAuthNr, ReqAuthenticator
from plenum_tpu_torch.node.pool_manager import TxnPoolManager
from plenum_tpu_torch.storage.kv_file import KvFile
from plenum_tpu_torch.storage.kv_memory import KvMemory


class NodeComponents(NamedTuple):
    db: DatabaseManager
    write_manager: WriteRequestManager
    read_manager: ReadRequestManager
    executor: LedgerBatchExecutor
    authenticator: ReqAuthenticator
    pool_manager: TxnPoolManager
    nym_handler: NymHandler
    node_handler: NodeHandler
    bls_signer: Optional[BlsCryptoSigner]
    bls_register: BlsKeyRegister
    bls_store: BlsStore
    plugins: list = []          # effective plugin objects (init'd by Node)
    action_manager: object = None
    # fused crypto pipeline (parallel/pipeline.py) the node's crypto
    # seams ride when constructed with one; co-hosted nodes share it
    pipeline: object = None


class NodeBootstrap:
    """Builds everything below the Node orchestrator."""

    def __init__(self, name: str,
                 genesis_txns: Optional[dict[int, Sequence[dict]]] = None,
                 data_dir: Optional[str] = None,
                 crypto_backend: str = "cuda",
                 bls_seed: Optional[bytes] = None,
                 verifier_min_batch: int = 128,
                 storage_backend: str = "native",
                 plugins=None,
                 verifier=None,
                 pipeline=None,
                 pipeline_lane: Optional[int] = None,
                 state_commitment: str = "mpt",
                 state_commitment_per_ledger: Optional[dict] = None,
                 verkle_width: Optional[int] = None):
        self.name = name
        self.genesis = genesis_txns or {}
        self.data_dir = data_dir
        # the card by default, as every entry point of the port; "cpu"
        # (hashlib and the CPU verifier) or "torch" when asked
        self.crypto_backend = crypto_backend
        # durable stores: "native" = the C++ log-structured engine
        # (LevelDB/RocksDB slot), "file" = the pure-python append log
        self.storage_backend = storage_backend
        # extension handlers (ref plugin_loader.py); merged with the
        # globally-registered set at build time
        self.plugins = list(plugins or [])
        self.bls_seed = bls_seed or name.encode().ljust(32, b"\0")[:32]
        # one fixed device-program shape covering the receive quotas: novel
        # shapes recompile
        self.verifier_min_batch = verifier_min_batch
        # explicit verifier override: co-hosted nodes pass ONE shared
        # CoalescingVerifier so their dispatches ride a single device
        # program per cycle (crypto/ed25519.py CoalescingVerifier)
        self.verifier = verifier
        # fused crypto pipeline (parallel/pipeline.py): when given, the
        # authenticator, every ledger's tree hasher, and the BLS batch
        # checks all stage into its shared ring (co-hosted nodes pass ONE
        # instance — that sharing IS the cross-node coalescing/dedup)
        self.pipeline = pipeline
        # multi-device ring placement pin: this node's submissions stage
        # into the named chip lane (sharded fabrics pin co-hosted
        # sub-pool shards to DISTINCT chips; None = ring-chosen lane)
        self.pipeline_lane = pipeline_lane
        # per-ledger state commitment scheme (state/commitment/): 'mpt'
        # default, 'verkle' for aggregated multi-key openings; the whole
        # pool must agree (the backend defines the signed root anchors)
        self.state_commitment = state_commitment
        self.state_commitment_per_ledger = \
            dict(state_commitment_per_ledger or {})
        self.verkle_width = verkle_width

    # --- storage factories -------------------------------------------------

    def _kv(self, label: str):
        if self.data_dir is None:
            return KvMemory()
        os.makedirs(self.data_dir, exist_ok=True)
        path = os.path.join(self.data_dir, label)
        has_native = os.path.exists(os.path.join(path, "kv.kvn"))
        has_file = os.path.exists(os.path.join(path, "kv.kvlog"))
        if self.storage_backend == "chunked" and not (has_native or has_file):
            # unbounded append logs split across sealed chunk files
            # (ref chunked_file_store.py); existing single-file/native
            # data keeps its on-disk format
            from plenum_tpu_torch.storage.kv_chunked import KvChunked
            return KvChunked(path)
        if self.storage_backend == "native" or has_native:
            from plenum_tpu_torch.storage.kv_native import (KvNative,
                                                            native_available)
            if native_available():
                if has_file and not has_native:
                    # existing KvFile data: honor the on-disk format rather
                    # than silently opening an empty native store
                    return KvFile(path)
                return KvNative(path)
            if has_native:
                # NEVER silently restart from genesis because the toolchain
                # went away: the durable data is in the native format
                raise RuntimeError(
                    f"{path} holds native-engine data but the native "
                    f"kvstore is unavailable (g++ build failed?)")
            import logging
            logging.getLogger(__name__).warning(
                "native kvstore unavailable; falling back to the "
                "pure-python file log for %s", path)
        return KvFile(path)

    def _ledger(self, ledger_id: int, label: str) -> Ledger:
        # crypto_backend routes to EVERY ledger's tree hasher — with "cuda"
        # the batch appends/proof paths run on the card (the north-star seam;
        # ref tree_hasher.py:4 + SURVEY.md §7 stage 2/3); with a pipeline,
        # hashing coalesces/dedups through its shared SHA lane instead
        hasher = (self.pipeline.tree_hasher() if self.pipeline is not None
                  else make_tree_hasher(self.crypto_backend))
        tree = CompactMerkleTree(
            hasher,
            hash_store=HashStore(self._kv(f"{label}_hashes")))
        return Ledger(tree, self._kv(f"{label}_log"),
                      genesis_txns=self.genesis.get(ledger_id, ()))

    # --- build -------------------------------------------------------------

    def _state(self, ledger_id: int, label: str):
        """Per-ledger state through the commitment seam: the configured
        scheme ('mpt' default; the Verkle backend additionally stages its
        batch commitment updates through the shared pipeline's commitment
        wave kind when one is wired)."""
        from plenum_tpu_torch.state.commitment import (backend_for_ledger,
                                                       make_state)
        backend = backend_for_ledger(ledger_id, self.state_commitment,
                                     self.state_commitment_per_ledger)
        return make_state(backend, db=self._kv(label),
                          width=self.verkle_width, pipeline=self.pipeline)

    def build(self) -> NodeComponents:
        db = DatabaseManager()
        # the commit drain's fused wave seam (execution/write_manager.py
        # `_commit_wave`): same pipeline the states commit through
        db.pipeline = self.pipeline
        # catchup order: audit, pool, config, domain (ref node.py:142)
        db.register_ledger(AUDIT_LEDGER_ID, self._ledger(AUDIT_LEDGER_ID, "audit"))
        db.register_ledger(POOL_LEDGER_ID, self._ledger(POOL_LEDGER_ID, "pool"),
                           self._state(POOL_LEDGER_ID, "pool_state"))
        db.register_ledger(CONFIG_LEDGER_ID, self._ledger(CONFIG_LEDGER_ID, "config"),
                           self._state(CONFIG_LEDGER_ID, "config_state"))
        db.register_ledger(DOMAIN_LEDGER_ID, self._ledger(DOMAIN_LEDGER_ID, "domain"),
                           self._state(DOMAIN_LEDGER_ID, "domain_state"))
        db.register_store(TS_STORE_LABEL,
                          StateTsStore(self._kv("ts_store")))
        db.register_store(SEQ_NO_DB_LABEL, self._kv("seq_no_db"))
        db.register_store(NODE_STATUS_DB_LABEL, self._kv("node_status_db"))
        bls_store = BlsStore(self._kv("bls_store"))
        db.register_store(BLS_STORE_LABEL, bls_store)

        # handlers + managers
        write_manager = WriteRequestManager(db)
        nym = NymHandler(db)
        bls_verifier = BlsCryptoVerifier()
        node_handler = NodeHandler(db, nym, bls_verifier=bls_verifier)
        write_manager.register_handler(nym)
        write_manager.register_handler(node_handler)
        write_manager.register_handler(TxnAuthorAgreementHandler(db, nym))
        write_manager.register_handler(TxnAuthorAgreementAmlHandler(db, nym))
        write_manager.register_handler(TxnAuthorAgreementDisableHandler(db, nym))
        write_manager.register_handler(LedgersFreezeHandler(db, nym))
        from plenum_tpu_torch.execution.handlers.attrib import (
            ATTRIB_STORE_LABEL, AttribHandler, GetAttrHandler)
        db.register_store(ATTRIB_STORE_LABEL, self._kv("attrib_db"))
        write_manager.register_handler(AttribHandler(db))
        read_manager = ReadRequestManager()
        read_manager.register_handler(GetAttrHandler(db))
        read_manager.register_handler(GetNymHandler(db))
        read_manager.register_handler(GetTxnHandler(db))
        read_manager.register_handler(GetTxnAuthorAgreementHandler(db))
        read_manager.register_handler(GetTxnAuthorAgreementAmlHandler(db))
        read_manager.register_handler(GetFrozenLedgersHandler(db))

        # action requests: privileged, node-local, no consensus
        # (ref action_request_manager.py; Node registers its own handlers)
        from plenum_tpu_torch.execution.action_manager import ActionRequestManager
        action_manager = ActionRequestManager(get_role=nym.get_role)

        # plugins contribute extra txn types before genesis replay so
        # plugin txns can even appear in genesis (ref plugin_loader.py)
        from plenum_tpu_torch.plugins import install_plugins
        self.effective_plugins = install_plugins(
            db, write_manager, read_manager, self.plugins)

        self._replay_genesis_state(db, nym, node_handler, write_manager)

        # client authN over the Ed25519 provider seam (cpu | torch |
        # cuda); with a pipeline the batches stage into the shared ring
        # instead of dispatching alone
        if self.verifier is not None:
            authn_verifier = self.verifier
        elif self.pipeline is not None:
            authn_verifier = self.pipeline.verifier(
                lane=self.pipeline_lane)
        else:
            authn_verifier = make_verifier(
                self.crypto_backend, min_batch=self.verifier_min_batch)
        authnr = ReqAuthenticator()
        authnr.register_authenticator(CoreAuthNr(
            authn_verifier, get_verkey=nym.get_verkey))

        # BLS: signer from seed; registry fed from pool state
        bls_signer = BlsCryptoSigner(seed=self.bls_seed)
        bls_register = BlsKeyRegister()
        pool_manager = TxnPoolManager(node_handler)
        self._sync_bls_register(bls_register, pool_manager)

        executor = LedgerBatchExecutor(write_manager)
        return NodeComponents(db, write_manager, read_manager, executor,
                              authnr, pool_manager, nym, node_handler,
                              bls_signer, bls_register, bls_store,
                              self.effective_plugins, action_manager,
                              self.pipeline)

    def _replay_genesis_state(self, db, nym, node_handler, wm) -> None:
        """Replay committed ledger txns through handlers into state (restart
        recovery / genesis seeding; ref ledgers_bootstrap init_state_from_ledger)."""
        handlers = {NYM: nym, NODE: node_handler}
        for h in wm._handlers.values():
            handlers.setdefault(h.txn_type, h)
        for lid in (POOL_LEDGER_ID, CONFIG_LEDGER_ID, DOMAIN_LEDGER_ID):
            ledger = db.get_ledger(lid)
            state = db.get_state(lid)
            if state is None or ledger.size == 0:
                continue
            if len(state.as_dict(committed=True)) > 0:
                continue                      # persistent state already built
            for seq_no in range(1, ledger.size + 1):
                txn = ledger.get_by_seq_no(seq_no)
                handler = handlers.get(txn_lib.txn_type_of(txn))
                if handler is not None:
                    handler.update_state(txn, is_committed=True)
            state.commit(state.head_hash)

    @staticmethod
    def _sync_bls_register(register: BlsKeyRegister,
                           pool_manager: TxnPoolManager) -> None:
        for name in pool_manager.node_names:
            register.set_key(name, pool_manager.bls_key_of(name))
