"""Reference path ``fleet/utils/sequence_parallel_utils.py`` (the
Megatron sequence-parallel scatter and gather and the linear layers
around them); implementation in ``parallel/mp_layers.py``."""
from ....parallel.mp_layers import (ColumnSequenceParallelLinear,
                                    RowSequenceParallelLinear, gather_seq,
                                    scatter_seq)

ScatterOp = scatter_seq
GatherOp = gather_seq

__all__ = ["ScatterOp", "GatherOp", "scatter_seq", "gather_seq",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]
