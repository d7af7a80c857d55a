from .seeder import SeederService
from .cons_proof import ConsProofService
from .rep import CatchupRepService
from .leecher import LedgerLeecherService, NodeLeecherService

__all__ = ["SeederService", "ConsProofService", "CatchupRepService",
           "LedgerLeecherService", "NodeLeecherService"]
