"""``fleet.meta_parallel`` subpackage path: the tensor-parallel layers
(``parallel/mp_layers.py``) and the model wrappers."""
from ....parallel.mp_layers import (ColumnParallelLinear,
                                    ColumnSequenceParallelLinear,
                                    ParallelCrossEntropy,
                                    RowParallelLinear,
                                    RowSequenceParallelLinear,
                                    VocabParallelEmbedding)
from .wrappers import (MetaParallelBase, PipelineParallel, ShardingParallel,
                       TensorParallel)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear",
           "MetaParallelBase", "PipelineParallel", "TensorParallel",
           "ShardingParallel"]
