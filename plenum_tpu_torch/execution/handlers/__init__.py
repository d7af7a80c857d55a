from .base import WriteRequestHandler, ReadRequestHandler
from .nym import NymHandler, GetNymHandler
from .node import NodeHandler
from .get_txn import GetTxnHandler
from .taa import (TxnAuthorAgreementHandler, TxnAuthorAgreementAmlHandler,
                  TxnAuthorAgreementDisableHandler, GetTxnAuthorAgreementHandler,
                  GetTxnAuthorAgreementAmlHandler)
from .freeze import LedgersFreezeHandler, GetFrozenLedgersHandler

__all__ = ["WriteRequestHandler", "ReadRequestHandler", "NymHandler",
           "GetNymHandler", "NodeHandler", "GetTxnHandler",
           "TxnAuthorAgreementHandler", "TxnAuthorAgreementAmlHandler",
           "TxnAuthorAgreementDisableHandler", "GetTxnAuthorAgreementHandler",
           "GetTxnAuthorAgreementAmlHandler", "LedgersFreezeHandler",
           "GetFrozenLedgersHandler"]
