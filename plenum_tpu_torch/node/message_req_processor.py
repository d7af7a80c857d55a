"""MessageReq/MessageRep: ask peers for a message we missed.

Reference behavior: plenum/server/message_req_processor.py:13 +
consensus/message_request/ — a node that detects a gap (a PRE-PREPARE it
only knows through PREPARE votes, a PROPAGATE it never received, a cited
VIEW_CHANGE vote it lacks, a NEW_VIEW that never arrived) broadcasts
MessageReq(msg_type, params); any peer holding the message answers with
MessageRep carrying it. Replies are never taken on trust: each type has a
validation anchor (prepare-quorum digest for PRE-PREPARE, client signature
via the normal propagate pipeline for PROPAGATE, the NewView's cited digest
for VIEW_CHANGE, full re-derivation for NEW_VIEW), so a lying responder
can waste bandwidth but not inject state.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from plenum_tpu_torch.common.internal_messages import MissingMessage
from plenum_tpu_torch.common.message_base import message_from_dict
from plenum_tpu_torch.common.node_messages import (MessageRep, MessageReq, NewView,
                                             PrePrepare, Propagate, ViewChange)

PROPAGATE = "PROPAGATE"
PREPREPARE = "PREPREPARE"
OLD_VIEW_PREPREPARE = "OLD_VIEW_PREPREPARE"
VIEW_CHANGE = "VIEW_CHANGE"
NEW_VIEW = "NEW_VIEW"


class MessageReqProcessor:
    """Node-level service: serves peers' MessageReqs from local stores and
    turns local MissingMessage events into MessageReqs."""

    THROTTLE = 3.0          # at most one identical request per this many secs

    def __init__(self, node):
        self._node = node
        self._recent: dict[tuple, float] = {}
        node.node_bus.subscribe(MessageReq, self.process_message_req)
        node.node_bus.subscribe(MessageRep, self.process_message_rep)

    # ------------------------------------------------------------------ #
    # requesting                                                         #
    # ------------------------------------------------------------------ #

    def request(self, msg_type: str, params: dict, dst=None) -> None:
        # dst is part of the throttle key: the body-fetch loop cycles
        # through CANDIDATE responders, and asking the next peer must not
        # be suppressed because the previous one was just asked
        key = (msg_type, tuple(sorted(params.items())),
               tuple(dst) if dst is not None else None)
        now = self._node.timer.get_current_time()
        if now - self._recent.get(key, float("-inf")) < self.THROTTLE:
            return
        self._recent[key] = now
        if len(self._recent) > 10000:       # bounded memory under spam
            cutoff = now - self.THROTTLE
            self._recent = {k: t for k, t in self._recent.items() if t >= cutoff}
        self._node.node_bus.send(MessageReq(msg_type=msg_type, params=params),
                                 dst)

    def process_missing(self, msg: MissingMessage) -> None:
        """Internal MissingMessage event → wire MessageReq."""
        self.request(msg.msg_type, dict(msg.key), dst=msg.dst)

    # ------------------------------------------------------------------ #
    # serving                                                            #
    # ------------------------------------------------------------------ #

    def process_message_req(self, msg: MessageReq, frm: str) -> None:
        server = {
            PROPAGATE: self._serve_propagate,
            PREPREPARE: self._serve_preprepare,
            OLD_VIEW_PREPREPARE: self._serve_old_view_preprepare,
            VIEW_CHANGE: self._serve_view_change,
            NEW_VIEW: self._serve_new_view,
        }.get(msg.msg_type)
        if server is None:
            return
        try:
            found = server(msg.params)
        except Exception:
            return                      # malformed params are not our problem
        if found is not None:
            self._node.node_bus.send(
                MessageRep(msg_type=msg.msg_type, params=msg.params,
                           msg=found.to_dict()), [frm])

    def _serve_propagate(self, params: dict) -> Optional[Propagate]:
        state = self._node.propagator.requests.get(str(params["digest"]))
        if state is None or state.request is None:
            # digest-gossip: we may hold only digest VOTES for this request
            # — never answer a body fetch with a bodyless state
            return None
        return Propagate(request=state.request.to_dict(),
                         sender_client=state.client_name)

    def _serve_preprepare(self, params: dict) -> Optional[PrePrepare]:
        inst_id = int(params["inst_id"])
        key = (int(params["view_no"]), int(params["pp_seq_no"]))
        if inst_id not in self._node.replicas:
            return None
        ordering = self._node.replicas[inst_id].ordering
        return ordering.prePrepares.get(key) or \
            ordering.sent_preprepares.get(key)

    def _serve_old_view_preprepare(self, params: dict) -> Optional[PrePrepare]:
        """Old-view pre-prepare cited by a NewView (ref
        OldViewPrePrepareRequest, ordering_service.py:2409); keyed by
        ORIGINAL view — peers that ordered it keep it in old_view_preprepares
        after view_change_started, or still in prePrepares if they ordered it
        in the cited view itself."""
        inst_id = int(params["inst_id"])
        key = (int(params["view_no"]), int(params["pp_seq_no"]))
        if inst_id not in self._node.replicas:
            return None
        ordering = self._node.replicas[inst_id].ordering
        found = ordering.old_view_preprepares.get(key)
        if found is not None:
            return found
        pp = ordering.prePrepares.get(key) or ordering.sent_preprepares.get(key)
        if pp is not None:
            orig = pp.original_view_no if pp.original_view_no is not None \
                else pp.view_no
            if orig == key[0]:
                return pp
        return None

    def _serve_view_change(self, params: dict) -> Optional[ViewChange]:
        vc_service = self._node.replicas.master.view_changer
        if vc_service is None:
            return None
        return vc_service._view_changes.get(
            int(params["view_no"]), {}).get(str(params["author"]))

    def _serve_new_view(self, params: dict) -> Optional[NewView]:
        vc_service = self._node.replicas.master.view_changer
        if vc_service is None:
            return None
        nv = vc_service._new_view
        if nv is not None and nv.view_no == int(params["view_no"]):
            return nv
        return None

    # ------------------------------------------------------------------ #
    # consuming replies                                                  #
    # ------------------------------------------------------------------ #

    def process_message_rep(self, msg: MessageRep, frm: str) -> None:
        if msg.msg is None:
            return
        try:
            inner = message_from_dict(dict(msg.msg))
        except Exception:
            return
        if msg.msg_type == PROPAGATE and isinstance(inner, Propagate):
            # the normal pipeline authenticates the client signature, counts
            # the responder's propagate vote, and dedups — exactly as if the
            # original PROPAGATE had arrived from this peer
            self._node._receive_propagate(inner, frm)
        elif msg.msg_type == PREPREPARE and isinstance(inner, PrePrepare):
            if inner.inst_id in self._node.replicas:
                self._node.replicas[inner.inst_id].ordering \
                    .process_requested_preprepare(inner)
        elif msg.msg_type == OLD_VIEW_PREPREPARE and \
                isinstance(inner, PrePrepare):
            if inner.inst_id in self._node.replicas:
                self._node.replicas[inner.inst_id].ordering \
                    .process_requested_old_view_preprepare(inner)
        elif msg.msg_type == VIEW_CHANGE and isinstance(inner, ViewChange):
            vc_service = self._node.replicas.master.view_changer
            if vc_service is not None:
                vc_service.process_requested_view_change(
                    inner, str(msg.params.get("author", "")))
        elif msg.msg_type == NEW_VIEW and isinstance(inner, NewView):
            vc_service = self._node.replicas.master.view_changer
            if vc_service is not None:
                vc_service.process_requested_new_view(inner)
