"""Request dissemination + propagate quorum (digest-gossip).

Reference behavior: plenum/server/propagator.py — on first sight of a client
REQUEST a node broadcasts PROPAGATE (:204); a request finalizes when f+1
matching propagates are seen (req_with_acceptable_quorum:132, set_finalised
:136) and is then forwarded to every replica's queue as a ReqKey. Matching
means same digest from distinct senders; a node's own propagate counts.

Redesign (digest-gossip): the reference floods the FULL request body
n*(n-1) times per transaction — the measured dominant wire cost past small
pools (docs/performance.md 7-node table: 87% of bytes). Here at most ONE
node broadcasts the body: the digest-DESIGNATED disseminator (derived from
the request digest over the sorted validator list, so every node picks the
same one with no coordination; clients broadcast to the whole pool, so
"the node that took the client request" is not unique). Every other vote
is a ~100-byte (digest, sender_client) pair. Votes count toward the f+1
finalization quorum regardless of which shape carried them; a node that
reaches quorum (or is asked to order) before holding the body pulls it
through MessageReq from one of the voters — the node-side fetch loop
retries the NEXT voter on timeout/bad reply. Forwarding to replicas — and
therefore batching/ordering — still requires the verified body: digest
votes can never finalize content nobody holds.

Outbound propagates buffer in an outbox the node flushes once per prod
tick as a single PropagateBatch, so the n^2 message COUNT (framing,
from_dict validation, inbox handling) amortizes across every request in
flight in the same tick.
"""
from __future__ import annotations

from typing import Callable, Optional

from plenum_tpu_torch.common.node_messages import Propagate, PropagateBatch
from plenum_tpu_torch.common.quorums import Quorums
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.tracing import NULL_TRACER, PROPAGATE_QUORUM


class RequestState:
    __slots__ = ("request", "propagates", "finalised", "forwarded",
                 "client_name", "executed", "added_at", "executed_at",
                 "fetch_started")

    def __init__(self, request: Optional[Request], added_at: float = 0.0):
        self.request = request                     # None until a body lands
        self.propagates: dict[str, bool] = {}      # sender node -> seen
        self.finalised = False
        self.forwarded = False
        self.executed = False
        self.client_name: Optional[str] = None     # who to REPLY to
        self.added_at = added_at                   # for unfinalized-state TTL
        self.executed_at: Optional[float] = None   # for executed-state TTL
        self.fetch_started = False                 # body fetch already queued


class Requests(dict):
    """digest -> RequestState (ref propagator.py Requests)."""

    def __init__(self, now: Callable[[], float]):
        super().__init__()
        self._now = now

    def add(self, request: Request) -> RequestState:
        state = self.get(request.digest)
        if state is None:
            state = self[request.digest] = RequestState(
                request, added_at=self._now())
        elif state.request is None:
            # digest votes arrived first; the body just landed (verified)
            state.request = request
        return state

    def add_digest(self, digest: str) -> RequestState:
        if digest not in self:
            self[digest] = RequestState(None, added_at=self._now())
        return self[digest]

    def add_propagate(self, request: Request, sender: str) -> RequestState:
        state = self.add(request)
        state.propagates[sender] = True
        return state

    def votes(self, digest: str) -> int:
        state = self.get(digest)
        return len(state.propagates) if state else 0

    def get_request(self, digest: str) -> Optional[Request]:
        state = self.get(digest)
        return state.request if state else None

    def has_body(self, digest: str) -> bool:
        state = self.get(digest)
        return state is not None and state.request is not None

    def mark_executed(self, digest: str) -> None:
        state = self.get(digest)
        if state:
            state.executed = True
            state.executed_at = self._now()

    def free(self, digest: str) -> None:
        self.pop(digest, None)


class Propagator:
    def __init__(self, name: str, quorums: Quorums,
                 send_to_nodes: Callable,
                 forward_to_replicas: Callable[[str], None],
                 now: Callable[[], float],
                 validators: Optional[Callable[[], list]] = None,
                 request_body: Optional[Callable[[str, bool], None]] = None,
                 digest_gossip: bool = True,
                 tracer=None):
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self.name = name
        self.quorums = quorums
        self.requests = Requests(now)
        self._send = send_to_nodes
        self._forward = forward_to_replicas
        self._validators = validators or (lambda: [name])
        # request_body(digest, urgent): node-side fetch loop (MessageReq to
        # a voter, retrying the next voter on timeout/bad reply). urgent
        # skips the grace delay that lets the client's own broadcast land.
        self._request_body = request_body or (lambda digest, urgent: None)
        self.digest_gossip = digest_gossip
        # outbox of (Propagate, is_body) flushed once per prod tick
        self._outbox: list[Propagate] = []

    def set_quorums(self, quorums: Quorums) -> None:
        self.quorums = quorums

    # ------------------------------------------------------------------ #
    # dissemination policy                                               #
    # ------------------------------------------------------------------ #

    def is_disseminator(self, digest: str) -> bool:
        """One deterministic body-broadcaster per digest: every node maps
        the digest onto the sorted validator list the same way. If the
        designated node never saw the request, the body still spreads via
        the per-digest fetch loop — liveness never hinges on one node."""
        validators = sorted(self._validators())
        if not validators:
            return True
        try:
            idx = int(digest[:8], 16) % len(validators)
        except ValueError:
            idx = 0
        return validators[idx] == self.name

    def _vote(self, request: Optional[Request], digest: str,
              sender_client: Optional[str]) -> None:
        """Queue our own propagate: the full body only when we hold it AND
        are the designated disseminator (or gossip is off); a compact
        digest vote otherwise."""
        if request is not None and (not self.digest_gossip
                                    or self.is_disseminator(digest)):
            self._outbox.append(Propagate(request=request.to_dict(),
                                          sender_client=sender_client))
        else:
            self._outbox.append(Propagate(digest=digest,
                                          sender_client=sender_client))

    def flush_outbox(self) -> None:
        """Coalesce this tick's queued propagates into one PropagateBatch
        broadcast (single messages go out bare — no envelope tax)."""
        if not self._outbox:
            return
        queued, self._outbox = self._outbox, []
        if len(queued) == 1:
            self._send(queued[0])
            return
        votes = tuple((p.digest, p.sender_client)
                      for p in queued if p.request is None)
        bodies = tuple(p.to_dict() for p in queued if p.request is not None)
        self._send(PropagateBatch(votes=votes, bodies=bodies))

    # ------------------------------------------------------------------ #
    # ingress                                                            #
    # ------------------------------------------------------------------ #

    def propagate(self, request: Request, client_name: Optional[str]) -> None:
        """First sight of a finalizable request: record own vote + broadcast.
        Body is present and signature-verified (client ingress path)."""
        state = self.requests.add(request)
        if client_name is not None:
            state.client_name = client_name
        if self.name not in state.propagates:
            state.propagates[self.name] = True
            self._vote(request, request.digest, client_name)
        self._try_finalize(request.digest)

    def process_propagate(self, msg: Propagate, frm: str) -> None:
        """A peer's body-carrying propagate (signature already verified by
        the node pipeline)."""
        request = Request.from_dict(msg.request)
        state = self.requests.add_propagate(request, frm)
        if state.client_name is None and msg.sender_client:
            state.client_name = msg.sender_client
        # relay our own vote the first time we see the request at all
        if self.name not in state.propagates:
            state.propagates[self.name] = True
            self._vote(request, request.digest, msg.sender_client)
        self._try_finalize(request.digest)

    def process_digest_vote(self, digest: str, frm: str,
                            sender_client: Optional[str]) -> None:
        """A peer's digest-only vote. Counts toward the quorum exactly like
        a body-carrying one; we do NOT echo a vote of our own until we hold
        the verified body (an honest vote always vouches for content its
        sender verified). A vote for a body we lack arms the fetch loop on
        a grace delay — the client's own broadcast usually outruns it."""
        state = self.requests.add_digest(digest)
        state.propagates[frm] = True
        if state.client_name is None and sender_client:
            state.client_name = sender_client
        if state.request is None and not state.fetch_started:
            state.fetch_started = True
            self._request_body(digest, False)
        self._try_finalize(digest)

    # ------------------------------------------------------------------ #
    # finalization                                                       #
    # ------------------------------------------------------------------ #

    def _try_finalize(self, digest: str) -> None:
        state = self.requests.get(digest)
        if state is None or state.finalised:
            return
        if not self.quorums.propagate.is_reached(len(state.propagates)):
            return
        if state.request is None:
            # quorum of digest votes with no body: ordering is waiting on
            # this request — fetch NOW (f+1 distinct voters guarantee at
            # least one honest body holder to pull from)
            state.fetch_started = True
            self._request_body(digest, True)
            return
        state.finalised = True
        if self._tracer.enabled:
            self._tracer.emit(PROPAGATE_QUORUM, digest,
                              {"votes": len(state.propagates)})
        if not state.forwarded:
            state.forwarded = True
            self._forward(digest)
