from .client_authn import CoreAuthNr, ReqAuthenticator
from .pool_manager import TxnPoolManager
from .bootstrap import NodeBootstrap

__all__ = ["CoreAuthNr", "ReqAuthenticator", "TxnPoolManager",
           "NodeBootstrap"]
