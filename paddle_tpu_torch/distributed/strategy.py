"""DistributedStrategy: the typed tree of strategy knobs (counterpart of
``paddle_tpu/distributed/strategy.py``, itself the dataclass form of
Paddle's ``distributed_strategy.proto``). Unknown fields land in
``extras`` so recipes port without edits. ``hybrid_configs`` carries the
degrees ``fleet.init`` builds the mesh from: ``dp_degree``,
``mp_degree``, ``sharding_degree``, ``sep_degree``, ``pp_degree`` and
``ep_degree`` (carved out of the data ranks)."""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict


@dataclass
class AmpConfig:
    enable: bool = False
    dtype: str = "bfloat16"
    level: str = "O1"
    init_loss_scaling: float = 65536.0
    use_dynamic_loss_scaling: bool = True
    custom_white_list: tuple = ()
    custom_black_list: tuple = ()


@dataclass
class RecomputeConfig:
    enable: bool = False
    checkpoints: tuple = ()
    policy: str = "full"


@dataclass
class ShardingConfig:
    """ZeRO stage 1 ("os"), 2 ("os_g") or 3 ("p_g_os") over the fsdp
    axis; ``offload`` keeps the optimizer state in pinned host memory."""
    enable: bool = False
    stage: int = 1
    degree: int = 1
    offload: bool = False
    comm_overlap: bool = False


@dataclass
class PipelineConfig:
    enable: bool = False
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"


@dataclass
class TensorParallelConfig:
    enable: bool = False
    tensor_parallel_degree: int = 1
    mp_async_allreduce: bool = False


@dataclass
class HybridConfig:
    dp_degree: int = 1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1
    ep_degree: int = 1


@dataclass
class DistributedStrategy:
    amp: AmpConfig = field(default_factory=AmpConfig)
    recompute: RecomputeConfig = field(default_factory=RecomputeConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    tensor_parallel: TensorParallelConfig = field(
        default_factory=TensorParallelConfig)
    hybrid_configs: HybridConfig = field(default_factory=HybridConfig)
    gradient_merge_micro_steps: int = 1
    find_unused_parameters: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)

    # strategy.hybrid_configs = {"dp_degree": 2, ...} sets the fields of
    # the sub-config, as the reference's wrapper lets recipes do
    def __setattr__(self, name, value):
        current = self.__dict__.get(name)
        if isinstance(value, dict) and hasattr(current,
                                               "__dataclass_fields__"):
            for k, v in value.items():
                if k not in current.__dataclass_fields__:
                    raise ValueError(f"{name} has no field {k!r}")
                setattr(current, k, v)
            return
        if name not in self.__dataclass_fields__ and name != "extras" and \
                not name.startswith("_") and "extras" in self.__dict__:
            self.extras[name] = value
            return
        object.__setattr__(self, name, value)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def __repr__(self):
        on = [n for n in ("amp", "recompute", "sharding", "pipeline",
                          "tensor_parallel")
              if getattr(getattr(self, n), "enable", False)]
        return (f"DistributedStrategy(enabled={on}, "
                f"hybrid={asdict(self.hybrid_configs)})")


__all__ = ["DistributedStrategy", "HybridConfig", "AmpConfig",
           "RecomputeConfig", "ShardingConfig", "PipelineConfig",
           "TensorParallelConfig"]
