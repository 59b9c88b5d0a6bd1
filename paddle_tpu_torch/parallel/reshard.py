"""Reshard-function registry over per-rank collectives (counterpart of
``paddle_tpu/parallel/reshard.py``).

One function per placement pair over one mesh axis, chosen by
:func:`choose_reshard_function`; :func:`reshard_with_registry` runs an
N-D transition as a sequence of such 1-D steps. Every function takes
and returns THIS rank's local tensor:

* S→R: all-gather the shards along the tensor dimension;
* R→S: keep this rank's chunk (no communication);
* S→S: all-to-all from one sharded dimension to another;
* P→R: all-reduce the partial values (sum);
* P→S: reduce-scatter them into this rank's chunk;
* R→P: rank 0 of the axis keeps the value, the others hold zeros, so
  that a later P→R gives the value back.

Placements are torch's (``Replicate``, ``Shard(dim)``, ``Partial``), one
per mesh axis in ``mesh.axes`` order, as in JAX.
"""

from __future__ import annotations

from typing import List, Sequence, Type

import torch
from torch.distributed.tensor import Partial, Placement, Replicate, Shard

from ..distributed import communication as comm
from .api import _resolve_mesh

__all__ = ["ReshardFunction", "register_reshard_function",
           "choose_reshard_function", "reshard_with_registry"]

_REGISTRY: List["ReshardFunction"] = []


def register_reshard_function(cls: Type["ReshardFunction"]):
    _REGISTRY.append(cls())
    return cls


class ReshardFunction:
    """One placement-pair transition over one mesh axis."""

    def is_suitable(self, src: Placement, dst: Placement) -> bool:
        raise NotImplementedError

    def eval(self, x: torch.Tensor, mesh, axis: str, src: Placement,
             dst: Placement) -> torch.Tensor:
        raise NotImplementedError


def _group(mesh, axis):
    return comm.Group(axis, mesh)


@register_reshard_function
class SToRReshardFunction(ReshardFunction):
    """Shard → Replicate: all-gather along the shard dimension."""

    def is_suitable(self, src, dst):
        return isinstance(src, Shard) and isinstance(dst, Replicate)

    def eval(self, x, mesh, axis, src, dst):
        return torch.cat(comm.all_gather(None, x.contiguous(),
                                         group=_group(mesh, axis)),
                         dim=src.dim)


@register_reshard_function
class RToSReshardFunction(ReshardFunction):
    """Replicate → Shard: this rank's chunk, no communication."""

    def is_suitable(self, src, dst):
        return isinstance(src, Replicate) and isinstance(dst, Shard)

    def eval(self, x, mesh, axis, src, dst):
        return x.chunk(mesh.axis_size(axis), dim=dst.dim)[
            mesh.coordinate(axis)].contiguous()


@register_reshard_function
class SToSReshardFunction(ReshardFunction):
    """Shard(i) → Shard(j): an all-to-all."""

    def is_suitable(self, src, dst):
        return (isinstance(src, Shard) and isinstance(dst, Shard)
                and src.dim != dst.dim)

    def eval(self, x, mesh, axis, src, dst):
        parts = [p.contiguous() for p in
                 x.chunk(mesh.axis_size(axis), dim=dst.dim)]
        got = comm.alltoall(parts, group=_group(mesh, axis))
        return torch.cat(got, dim=src.dim)


@register_reshard_function
class PToRReshardFunction(ReshardFunction):
    """Partial → Replicate: an all-reduce (sum)."""

    def is_suitable(self, src, dst):
        return isinstance(src, Partial) and isinstance(dst, Replicate)

    def eval(self, x, mesh, axis, src, dst):
        return comm.all_reduce(x.clone(), group=_group(mesh, axis))


@register_reshard_function
class PToSReshardFunction(ReshardFunction):
    """Partial → Shard: a reduce-scatter along the shard dimension."""

    def is_suitable(self, src, dst):
        return isinstance(src, Partial) and isinstance(dst, Shard)

    def eval(self, x, mesh, axis, src, dst):
        n = mesh.axis_size(axis)
        parts = [p.contiguous() for p in x.chunk(n, dim=dst.dim)]
        return comm.reduce_scatter(None, parts, group=_group(mesh, axis))


@register_reshard_function
class RToPReshardFunction(ReshardFunction):
    """Replicate → Partial: rank 0 of the axis keeps the value, the
    others hold zeros."""

    def is_suitable(self, src, dst):
        return isinstance(src, Replicate) and isinstance(dst, Partial)

    def eval(self, x, mesh, axis, src, dst):
        return x.clone() if mesh.coordinate(axis) == 0 else \
            torch.zeros_like(x)


def choose_reshard_function(src: Placement,
                            dst: Placement) -> ReshardFunction:
    for fn in _REGISTRY:
        if fn.is_suitable(src, dst):
            return fn
    raise NotImplementedError(f"no reshard function for {src} -> {dst}")


def _same(a: Placement, b: Placement) -> bool:
    return type(a) is type(b) and getattr(a, "dim", None) == getattr(
        b, "dim", None)


def reshard_with_registry(x: torch.Tensor, mesh,
                          src_placements: Sequence[Placement],
                          dst_placements: Sequence[Placement]
                          ) -> torch.Tensor:
    """This rank's local tensor under ``dst_placements`` from its local
    tensor under ``src_placements`` (one placement per mesh axis, in
    ``mesh.axes`` order), one axis at a time."""
    hm = _resolve_mesh(mesh)
    if len(src_placements) != len(hm.axes) or \
            len(dst_placements) != len(hm.axes):
        raise ValueError(f"need one placement per mesh axis {hm.axes}")
    for axis, s, d in zip(hm.axes, src_placements, dst_placements):
        if _same(s, d):
            continue
        x = choose_reshard_function(s, d).eval(x, hm, axis, s, d)
    return x
