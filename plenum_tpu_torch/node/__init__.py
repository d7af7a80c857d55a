from .client_authn import CoreAuthNr, ReqAuthenticator
from .propagator import Propagator, Requests
from .pool_manager import TxnPoolManager
from .bootstrap import NodeBootstrap
from .node import Node

__all__ = ["CoreAuthNr", "ReqAuthenticator", "Propagator", "Requests",
           "TxnPoolManager", "NodeBootstrap", "Node"]
