from .sim_random import SimRandom
from .sim_network import SimNetwork, Discard, Deliver, Stash, Mutate, Rule
from .sim_network import match_frm, match_dst, match_type
from .sim_network import LinkProfile, Topology, make_topology

__all__ = ["SimRandom", "SimNetwork", "Discard", "Deliver", "Stash",
           "Mutate", "Rule",
           "match_frm", "match_dst", "match_type",
           "LinkProfile", "Topology", "make_topology"]
