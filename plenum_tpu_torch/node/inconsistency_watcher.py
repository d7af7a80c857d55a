"""Network-inconsistency watcher: detect losing quorum connectivity.

Reference behavior: plenum/server/inconsistency_watchers.py:5
(NetworkInconsistencyWatcher) — once a node has SEEN strong-quorum
connectivity (n-f peers up, i.e. consensus was reachable), dropping below
weak-quorum connectivity (f+1) means the node can no longer tell a
functioning pool from a partition: it must stop trusting its own liveness
view and resynchronize. The reference routes the callback to a node
restart; here the node wires it to `start_catchup` (our recovery path —
catchup pauses ordering, reverts uncommitted work and resyncs, which is
the restart path's actual payload) and a metrics event.

The "had it, lost it" edge matters: a node that never reached strong
connectivity (e.g. still dialing at startup) must NOT fire — otherwise
every cold start would loop through spurious recoveries.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

from plenum_tpu_torch.common.event_bus import ExternalBus
from plenum_tpu_torch.common.quorums import Quorums


class NetworkInconsistencyWatcher:
    """Tracks peer connectivity against the pool's quorum thresholds.

    Counts CONNECTED PEERS (self excluded, exactly the transport's view);
    thresholds come from Quorums(n) over the full membership, mirroring
    the reference's accounting: strong = commit quorum (n-f), weak =
    propagate quorum (f+1).
    """

    def __init__(self, callback: Callable[[], None],
                 network: Optional[ExternalBus] = None):
        self.callback = callback
        self._connected: set[str] = set()
        self._nodes: set[str] = set()
        self._quorums = Quorums(0)
        self._reached_strong = False
        if network is not None:
            network.subscribe(ExternalBus.Connected, self._on_connected)
            network.subscribe(ExternalBus.Disconnected, self._on_disconnected)

    # --- membership -------------------------------------------------------

    def set_nodes(self, nodes: Iterable[str]) -> None:
        """Pool membership changed (pool-ledger commit): recompute the
        thresholds; connectivity already gathered keeps counting."""
        self._nodes = set(nodes)
        self._quorums = Quorums(len(self._nodes))

    @property
    def nodes(self) -> set[str]:
        return self._nodes

    # --- transport events -------------------------------------------------

    def _on_connected(self, msg, frm: str = "") -> None:
        self.connect(msg.name)

    def _on_disconnected(self, msg, frm: str = "") -> None:
        self.disconnect(msg.name)

    def connect(self, name: str) -> None:
        self._connected.add(name)
        if not self._nodes:
            return      # membership unknown: Quorums(0) is trivially true
        if self._quorums.commit.is_reached(len(self._connected)):
            self._reached_strong = True

    def disconnect(self, name: str) -> None:
        self._connected.discard(name)
        if (self._nodes and self._reached_strong
                and not self._quorums.propagate.is_reached(
                    len(self._connected))):
            # lost weak-quorum connectivity after having had consensus
            # connectivity: one shot until strong connectivity returns
            self._reached_strong = False
            self.callback()

    def has_weak_connectivity(self) -> bool:
        return self._quorums.propagate.is_reached(len(self._connected))
