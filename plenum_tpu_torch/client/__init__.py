from .wallet import Wallet
from .client import PoolClient
from .pipelined import PipelinedPoolClient
from .sim_clients import SimClientPopulation, burst_writes

__all__ = ["Wallet", "PoolClient", "PipelinedPoolClient",
           "SimClientPopulation", "burst_writes"]
