"""Reference path ``fleet/base/topology.py``; implementation in
``distributed/topology.py``."""
from ...topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]
