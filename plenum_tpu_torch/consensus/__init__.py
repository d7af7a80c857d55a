from .batch_id import BatchID
from .consensus_shared_data import ConsensusSharedData
from .primary_selector import RoundRobinPrimariesSelector

__all__ = ["BatchID", "ConsensusSharedData", "RoundRobinPrimariesSelector"]
