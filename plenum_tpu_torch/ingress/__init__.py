"""Million-client ingress plane: the pool's front door.

``IngressPlane`` multiplexes huge client populations onto a node with
per-client bounded queues, weighted-fair dequeue, watermark-based
shedding (explicit ``LoadShed`` replies — shed-before-wedge) and batched
client authentication through the node's ``ReqAuthenticator`` seam;
``IngressController`` closes the admission loop toward a queue-wait SLO;
``ObserverReadGate`` / ``SimObserver`` serve PR 4 verified-read
envelopes from replicated observer state so reads scale horizontally
without touching consensus quorums. See docs/ingress.md.
"""
from .controller import IngressController, make_ingress_controller
from .observer_reads import ObserverFleet, ObserverReadGate, SimObserver
from .plane import SHED_CLIENT_CAP, SHED_OVERLOAD, IngressPlane

__all__ = ["IngressPlane", "IngressController", "make_ingress_controller",
           "ObserverFleet", "ObserverReadGate", "SimObserver",
           "SHED_OVERLOAD", "SHED_CLIENT_CAP"]
