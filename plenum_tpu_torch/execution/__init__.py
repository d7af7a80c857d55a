from .database_manager import DatabaseManager
from .write_manager import WriteRequestManager, ThreePcBatch
from .read_manager import ReadRequestManager
from .executor import LedgerBatchExecutor

__all__ = ["DatabaseManager", "WriteRequestManager", "ThreePcBatch",
           "ReadRequestManager", "LedgerBatchExecutor"]
