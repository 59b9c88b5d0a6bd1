"""Hybrid-parallel topology facade (counterpart of
``paddle_tpu/distributed/topology.py``): ``CommunicateTopology`` (rank
coordinates over the axes "data", "pipe", "sharding", "sep", "model")
and ``HybridCommunicateGroup`` (degree and group queries over the
:class:`~paddle_tpu_torch.parallel.mesh.HybridMesh`)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.mesh import HybridMesh, current_mesh
from .communication import Group

# reference axis name -> mesh axis name
_AXIS_ALIAS = {"data": "dp", "pipe": "pp", "sharding": "fsdp", "sep": "sep",
               "model": "tp", "dp": "dp", "pp": "pp", "fsdp": "fsdp",
               "tp": "tp", "mp": "tp"}


class CommunicateTopology:
    """Coordinate math over the hybrid axes, ranks in row-major order of
    ``dims``."""

    def __init__(self, hybrid_group_names: Sequence[str] = ("data", "pipe",
                                                            "sharding", "sep",
                                                            "model"),
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world = int(np.prod(dims))
        coords = np.indices(dims).reshape(len(dims), -1).T
        self._coord_of = {rank: tuple(int(v) for v in c)
                          for rank, c in enumerate(coords)}

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world

    def get_rank(self, **axis_coords) -> int:
        coord = tuple(axis_coords[n] for n in self._parallel_names)
        for rank, c in self._coord_of.items():
            if c == coord:
                return rank
        raise ValueError(f"no rank at {axis_coords}")

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return self._coord_of[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """Every rank whose coordinate along ``axis_name`` is ``index``."""
        ai = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._coord_of.items() if c[ai] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The rank groups that communicate along ``axis_name`` (every
        other coordinate fixed)."""
        ai = self._parallel_names.index(axis_name)
        groups: Dict[Tuple, List[int]] = {}
        for r, c in self._coord_of.items():
            groups.setdefault(c[:ai] + c[ai + 1:], []).append(r)
        return [sorted(v) for _, v in sorted(groups.items())]


class HybridCommunicateGroup:
    """Degree, rank and group queries of the reference's
    HybridCommunicateGroup over a HybridMesh (the current one when
    none is given)."""

    def __init__(self, hybrid_mesh: Optional[HybridMesh] = None):
        self._hm = hybrid_mesh

    @property
    def hm(self) -> HybridMesh:
        hm = self._hm or current_mesh()
        if hm is None:
            raise RuntimeError("no active HybridMesh")
        return hm

    def topology(self) -> CommunicateTopology:
        names = ["data", "pipe", "sharding", "sep", "model"]
        return CommunicateTopology(
            names, [self.hm.axis_size(_AXIS_ALIAS[n]) for n in names])

    def get_data_parallel_world_size(self) -> int:
        return self.hm.get_data_parallel_world_size()

    def get_model_parallel_world_size(self) -> int:
        return self.hm.get_model_parallel_world_size()

    def get_pipe_parallel_world_size(self) -> int:
        return self.hm.get_pipe_parallel_world_size()

    def get_sharding_parallel_world_size(self) -> int:
        return self.hm.get_sharding_parallel_world_size()

    def get_sep_parallel_world_size(self) -> int:
        return self.hm.get_sep_parallel_world_size()

    # this rank's index along each axis (the reference's rank queries)
    def get_data_parallel_rank(self) -> int:
        return self.hm.group_rank(("dp", "ep", "fsdp"))

    def get_model_parallel_rank(self) -> int:
        return self.hm.coordinate("tp")

    def get_stage_id(self) -> int:
        return self.hm.coordinate("pp")

    def get_sharding_parallel_rank(self) -> int:
        return self.hm.coordinate("fsdp")

    def get_sep_parallel_rank(self) -> int:
        return self.hm.coordinate("sep")

    def get_global_rank(self) -> int:
        return self.hm.rank

    def get_data_parallel_group(self) -> Group:
        return Group(("dp", "fsdp"), self.hm)

    def get_model_parallel_group(self) -> Group:
        return Group("tp", self.hm)

    def get_pipe_parallel_group(self) -> Group:
        return Group("pp", self.hm)

    def get_sharding_parallel_group(self) -> Group:
        return Group("fsdp", self.hm)

    def get_sep_parallel_group(self) -> Group:
        return Group("sep", self.hm)

    def get_check_parallel_group(self) -> Group:
        return Group(self.hm.axes, self.hm)


__all__ = ["CommunicateTopology", "HybridCommunicateGroup"]
