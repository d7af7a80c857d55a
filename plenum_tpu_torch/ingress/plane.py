"""The pool's front door: admission control, fair queueing, batched auth.

A validator's raw client inbox treats every arriving message alike: a
million mostly-idle clients and one flooding hot client both land in ONE
list the prod loop drains under a quota, and every write pays its own
signature verification. ``IngressPlane`` multiplexes a huge client
population onto the node pipeline with three mechanisms:

1. **Admission control + fair queueing.** Each client gets a BOUNDED
   queue (``INGRESS_CLIENT_QUEUE_CAP``); a weighted-fair (deficit
   round-robin) dequeue drains the active clients into the node pipeline,
   so one hot client's backlog cannot starve everyone else's single
   request. The SUM of all queues rides a watermark pair: above the
   (controller-steered) shed watermark, NEW arrivals get an explicit
   ``LoadShed`` reply until the total drains below the low mark
   (hysteresis) — shed-before-wedge: floods degrade service with honest
   refusals instead of wedging the node's inbox.

2. **Batched client authentication.** Each tick's fair-dequeued writes
   go through ``ReqAuthenticator.submit_batch`` / ``collect_batch``
   (node/client_authn.py) as ONE device dispatch — client-auth cost
   amortizes across the admitted batch exactly like commit-sig cost
   already does on the ordering path. The dispatch is pipelined (one in
   flight; the plane keeps admitting while the device computes), and
   verified requests enter the node through ``Node.submit_preverified``,
   which skips the node's own re-dispatch.

3. **Closed-loop admission.** An AIMD controller (controller.py) steers
   the dequeue budget and the effective shed watermark from queue-wait
   p95 toward ``INGRESS_SLO_P95``.

Reads and observer registrations pass straight through to the node: the
read plane already batches per-tick query sets, and at scale reads go to
OBSERVERS (ingress/observer_reads.py), not through this plane at all.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Optional

from plenum_tpu_torch.common import tracing
from plenum_tpu_torch.common.metrics import MetricsName
from plenum_tpu_torch.common.node_messages import LoadShed, RequestNack
from plenum_tpu_torch.common.request import Request
from plenum_tpu_torch.common.timer import RepeatingTimer
from plenum_tpu_torch.execution.exceptions import InvalidClientRequest

SHED_OVERLOAD = "ingress overloaded: queue watermark reached"
SHED_CLIENT_CAP = "ingress: per-client queue full"


class IngressPlane:
    MAX_AUTH_POLLS = 50

    def __init__(self, node, config=None, tracer=None, metrics=None,
                 send=None, tick: bool = True, sink=None):
        self.node = node
        self.config = config or node.config
        self.timer = node.timer
        self.tracer = tracer if tracer is not None else node.tracer
        self.metrics = metrics if metrics is not None else node.metrics
        self._send = send or node._client_send
        # where verified writes go. Default: this node's own pipeline
        # (submit_preverified, resolved late so the node attribute stays
        # swappable). A sharded deployment hands a ShardRouter route
        # here instead — admission + the batched auth dispatch happen
        # ONCE at this front door, then the write is fanned to whichever
        # sub-pool owns its key (shards/router.py)
        self._sink = sink if sink is not None else (
            lambda req, frm: self.node.submit_preverified(req, frm))

        # client -> deque[(Request, frm, enqueue_ts)]; rotation holds each
        # ACTIVE client once, weights grant >1 dequeues per rotation pass
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._rotation: deque = deque()
        self._weights: dict[str, int] = {}
        self._total = 0
        self._shedding = False          # watermark hysteresis latch
        self._forced_watermark = None   # autopilot ladder clamp
        self._inflight = None           # (token, entries, polls)

        from .controller import make_ingress_controller
        self.controller = make_ingress_controller(
            self.config, self.timer, tracer=self.tracer,
            metrics=self.metrics)

        self.stats = {"submitted": 0, "admitted": 0, "shed": 0,
                      "shed_overload": 0, "shed_client_cap": 0,
                      "auth_batches": 0, "auth_items": 0, "auth_fail": 0,
                      "nacked": 0, "passthrough": 0, "queue_depth_max": 0,
                      # ingress-SLO ledger for the telemetry plane's
                      # burn-rate tracking: one check per dequeued write,
                      # a violation when its queue wait exceeded
                      # INGRESS_SLO_P95 (cumulative; the snapshot source
                      # takes deltas)
                      "slo_checks": 0, "slo_violations": 0}
        # register as a telemetry source: the front door's queue depth,
        # shed state, and SLO ledger are fleet-health signals
        # (observability/snapshot.py); one guarded attribute check when
        # telemetry is disabled
        telemetry = getattr(node, "telemetry", None)
        if telemetry is not None and telemetry.enabled:
            from plenum_tpu_torch.observability import CumulativeDelta
            self._telemetry_deltas = CumulativeDelta()
            # distinct clients hitting their per-client cap this
            # snapshot interval — the breadth rule's input
            self._capped_clients: set = set()
            telemetry.add_source("ingress", self._telemetry_state)

        self._tick_timer = None
        if tick:
            self._tick_timer = RepeatingTimer(
                self.timer, self.config.INGRESS_TICK_INTERVAL, self.service)

    def stop(self) -> None:
        if self._tick_timer is not None:
            self._tick_timer.stop()

    # --- knobs ------------------------------------------------------------

    def set_weight(self, client: str, weight: int) -> None:
        """Dequeues granted to `client` per fair-rotation pass (default 1)."""
        self._weights[client] = max(1, int(weight))

    def force_shed_watermark(self, value) -> None:
        """Orchestrated degradation (the autopilot ladder's shed-harder
        step): clamp the effective shed watermark to `value`, overriding
        both the static config mark and the AIMD controller's steering.
        None releases the clamp (back to controller/config)."""
        self._forced_watermark = None if value is None \
            else max(1, int(value))

    @property
    def shed_watermark(self) -> int:
        if self._forced_watermark is not None:
            return self._forced_watermark
        if self.controller is not None:
            return self.controller.shed_watermark
        return self.config.INGRESS_HIGH_WATERMARK

    @property
    def admit_budget(self) -> int:
        if self.controller is not None:
            return self.controller.admit_max
        return self.config.INGRESS_ADMIT_MAX

    @property
    def queue_depth(self) -> int:
        return self._total

    # --- ingress ----------------------------------------------------------

    def submit(self, msg: dict, frm: str) -> None:
        """One client message at the front door. Reads, actions on the
        pass-through path, and anything the plane cannot classify go
        straight to the node (its pipeline validates them); writes pay
        admission control and queue for the batched verifier."""
        self.stats["submitted"] += 1
        if not isinstance(msg, dict) or msg.get("op") == "OBSERVER_REGISTER":
            self.node.handle_client_message(msg, frm)
            self.stats["passthrough"] += 1
            return
        try:
            request = Request.from_dict(msg)
        except Exception:
            self._send(RequestNack(identifier=str(msg.get("identifier")),
                                   req_id=msg.get("reqId") or 0,
                                   reason="malformed request"), frm)
            self.stats["nacked"] += 1
            return
        if self.node.c.read_manager.is_query_type(request.txn_type):
            # the node's read plane batches the tick's query set already;
            # at scale reads belong on observers and never reach here
            self.node.handle_client_message(msg, frm)
            self.stats["passthrough"] += 1
            return
        is_action = (self.node.action_manager is not None
                     and self.node.action_manager.is_action_type(
                         request.txn_type))
        if not is_action:
            if not self.node.c.write_manager.is_write_type(request.txn_type):
                self._send(RequestNack(
                    identifier=request.identifier, req_id=request.req_id,
                    reason=f"unknown txn type {request.txn_type!r}"), frm)
                self.stats["nacked"] += 1
                return
            try:
                # static validation BEFORE the queue: garbage must not
                # occupy admission capacity or a device-batch slot
                self.node.c.write_manager.static_validation(request)
            except InvalidClientRequest as e:
                self._send(RequestNack(identifier=request.identifier,
                                       req_id=request.req_id,
                                       reason=e.reason), frm)
                self.stats["nacked"] += 1
                return
        self._admit(request, frm)

    def _admit(self, request: Request, frm: str) -> None:
        q = self._queues.get(frm)
        if q is not None and len(q) >= self.config.INGRESS_CLIENT_QUEUE_CAP:
            self._shed(request, frm, SHED_CLIENT_CAP, "shed_client_cap")
            return
        watermark = self.shed_watermark
        if self._shedding:
            if self._total > self.config.INGRESS_LOW_WATERMARK:
                self._shed(request, frm, SHED_OVERLOAD, "shed_overload")
                return
            self._shedding = False      # drained below the low mark
        elif self._total >= watermark:
            self._shedding = True
            self._shed(request, frm, SHED_OVERLOAD, "shed_overload")
            return
        if q is None:
            q = self._queues[frm] = deque()
        if not q:                       # newly active client joins rotation
            self._rotation.append(frm)
        q.append((request, frm, self.timer.get_current_time()))
        self._total += 1
        self.stats["queue_depth_max"] = max(self.stats["queue_depth_max"],
                                            self._total)
        self.stats["admitted"] += 1
        self.metrics.add_event(MetricsName.INGRESS_ADMITTED)
        if self.tracer.enabled:
            self.tracer.emit(tracing.ING_ADMIT, request.digest, {"frm": frm})

    def _shed(self, request: Request, frm: str, reason: str,
              stat: str) -> None:
        self.stats["shed"] += 1
        self.stats[stat] += 1
        # an OVERLOAD shed spends ingress error budget: the pool refused
        # work it should have absorbed. A per-client-cap shed goes into
        # the ledger only via the BREADTH rule at snapshot time (many
        # distinct clients capped in one interval = overload; one
        # abusive client being fairness-limited must not page the pool
        # SLO alert while every well-behaved client is served in bounds)
        if stat == "shed_overload":
            self.stats["slo_checks"] += 1
            self.stats["slo_violations"] += 1
        elif stat == "shed_client_cap" and hasattr(self,
                                                   "_capped_clients"):
            self._capped_clients.add(frm)
        self.metrics.add_event(MetricsName.INGRESS_SHED)
        self._send(LoadShed(identifier=request.identifier,
                            req_id=request.req_id, reason=reason,
                            retry_after=self.config.INGRESS_TICK_INTERVAL),
                   frm)
        if self.tracer.enabled:
            self.tracer.emit(tracing.ING_SHED, request.digest,
                             {"frm": frm, "reason": reason})

    # --- the service tick -------------------------------------------------

    def service(self) -> int:
        """One tick: finish the in-flight auth dispatch, then fair-dequeue
        up to the admission budget into one new dispatch. Returns the
        number of requests whose verdicts landed this tick."""
        done = self._poll_inflight()
        if self._inflight is not None:
            return done                 # device still computing: keep
            # admitting (queues fill toward the watermark — that IS the
            # backpressure), dispatch again next tick
        self.metrics.add_event(MetricsName.INGRESS_QUEUE_DEPTH, self._total)
        if not self._total:
            return done
        batch = self._fair_dequeue(self.admit_budget)
        if not batch:
            return done
        # within-batch dedup: one device verify per digest; every copy of
        # that digest settles on the shared verdict (the signature is part
        # of the digest, so same digest = same signed bytes)
        entries: "OrderedDict[str, list]" = OrderedDict()
        for req, frm, t_enq in batch:
            entries.setdefault(req.digest, []).append((req, frm))
        uniques = [group[0][0] for group in entries.values()]
        token = self.node.c.authenticator.submit_batch(uniques)
        n_items = self.node.c.authenticator.token_item_count(token)
        self.stats["auth_batches"] += 1
        self.stats["auth_items"] += n_items
        self.metrics.add_event(MetricsName.INGRESS_AUTH_BATCH, n_items)
        if self.tracer.enabled:
            self.tracer.emit(tracing.ING_AUTH, "",
                             {"n": len(uniques), "sigs": n_items})
        verdicts = self.node.c.authenticator.collect_batch(token, wait=False)
        if verdicts is None:
            self._inflight = (token, entries, 0)
            return done
        self._finish(entries, verdicts)
        return done + sum(len(g) for g in entries.values())

    def _poll_inflight(self) -> int:
        if self._inflight is None:
            return 0
        token, entries, polls = self._inflight
        verdicts = self.node.c.authenticator.collect_batch(
            token, wait=polls >= self.MAX_AUTH_POLLS)
        if verdicts is None:
            self._inflight = (token, entries, polls + 1)
            return 0
        self._inflight = None
        self._finish(entries, verdicts)
        return sum(len(g) for g in entries.values())

    def _fair_dequeue(self, budget: int) -> list:
        """Deficit-round-robin drain: each rotation pass grants every
        active client `weight` dequeues, so under backlog the budget
        splits max-min fairly across clients instead of FIFO-rewarding
        whoever flooded first. Queue-wait samples feed the controller."""
        out: list = []
        now = self.timer.get_current_time()
        fairness: dict[str, int] = {}
        while len(out) < budget and self._rotation:
            client = self._rotation[0]
            q = self._queues.get(client)
            if not q:
                self._rotation.popleft()
                self._queues.pop(client, None)
                continue
            grant = min(self._weights.get(client, 1), len(q),
                        budget - len(out))
            for _ in range(grant):
                req, frm, t_enq = q.popleft()
                self._total -= 1
                wait = now - t_enq
                self.metrics.add_event(MetricsName.INGRESS_QUEUE_WAIT, wait)
                self.stats["slo_checks"] += 1
                if wait > self.config.INGRESS_SLO_P95:
                    self.stats["slo_violations"] += 1
                if self.controller is not None:
                    self.controller.note_admitted(wait)
                out.append((req, frm, t_enq))
                fairness[client] = fairness.get(client, 0) + 1
            self._rotation.rotate(-1)
            if not q:
                # drained: drop from rotation. After rotate(-1) the
                # client sits at the BACK — pop() is O(1) where a
                # remove() scan would make a 10k-client drain quadratic
                if self._rotation and self._rotation[-1] == client:
                    self._rotation.pop()
                self._queues.pop(client, None)
        if len(fairness) > 1:
            counts = list(fairness.values())
            self.metrics.add_event(
                MetricsName.INGRESS_FAIRNESS_SPREAD,
                max(counts) / (sum(counts) / len(counts)))
        self.metrics.add_event(MetricsName.INGRESS_CLIENTS, len(self._queues))
        return out

    def _finish(self, entries, verdicts) -> None:
        ok_n = fail_n = 0
        for (digest, group), ok in zip(entries.items(), verdicts):
            for req, frm in group:
                if ok:
                    ok_n += 1
                    self._sink(req, frm)
                else:
                    fail_n += 1
                    self.stats["auth_fail"] += 1
                    self.metrics.add_event(MetricsName.INGRESS_AUTH_FAIL)
                    self._send(RequestNack(
                        identifier=req.identifier, req_id=req.req_id,
                        reason="signature verification failed"), frm)
        if self.tracer.enabled:
            self.tracer.emit(tracing.ING_VERDICT, "",
                             {"ok": ok_n, "fail": fail_n})

    # --- reporting --------------------------------------------------------

    def _telemetry_state(self) -> dict:
        """Front-door section of the node's telemetry snapshot: live
        queue depth, the shed latch, per-interval shed volume, and the
        ingress-SLO ledger deltas the burn-rate tracker consumes."""
        out = {
            "queue_depth": self._total,
            "active_clients": len(self._queues),
            "shedding": self._shedding,
            "watermark": self.shed_watermark,
        }
        take = self._telemetry_deltas.take
        d_shed = take("shed", self.stats["shed"])
        if d_shed:
            out["shed"] = d_shed
        d_v = take("slo_v", self.stats["slo_violations"])
        d_n = take("slo_n", self.stats["slo_checks"])
        # the BREADTH rule: per-client-cap sheds count against the pool
        # SLO only when MANY distinct clients were capped this interval
        # (aggregate demand outran the pool = overload); below the
        # breadth floor it is the fairness mechanism doing its job on a
        # few abusers and must not burn the pool's error budget
        d_cap = take("cap_shed", self.stats["shed_client_cap"])
        breadth = len(self._capped_clients)
        self._capped_clients.clear()
        if d_cap and breadth >= getattr(self.config,
                                        "INGRESS_SLO_CAP_BREADTH", 3):
            d_v += d_cap
            d_n += d_cap
        if d_n > 0:
            out["slo"] = [d_v, d_n]
        return out

    def summary(self) -> dict:
        out = dict(self.stats)
        out["queue_depth"] = self._total
        out["active_clients"] = len(self._queues)
        out["watermark"] = self.shed_watermark
        out["admit_budget"] = self.admit_budget
        if self.stats["auth_batches"]:
            out["auth_batch_mean"] = round(
                self.stats["auth_items"] / self.stats["auth_batches"], 2)
        if self.controller is not None:
            out["controller"] = self.controller.trajectory()
        return out
