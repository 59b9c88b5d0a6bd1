"""Pipeline parallelism (counterpart of ``paddle_tpu/parallel/pipeline.py``):
layer descriptors, their segmentation into stages, microbatching, and
the pipelined stack of identical layers.

The JAX package stacks a homogeneous run of layers into leaves
``[L, ...]`` (``[V, S, k, ...]`` for the interleaved schedule), shards
the leading axis over ``pp`` and runs every stage in one SPMD program.
The port keeps one module a layer: :class:`PipelineStack` holds layer i
as ``layers.<i>`` (the names ``nn.ModuleList`` gives), virtual stage vs
is layers [vs·k, (vs+1)·k) with k = L / (S·V), and it runs on stage
vs mod S (for V = 1, stage s holds layers [s·k, (s+1)·k)). On a ``pp``
mesh each rank keeps only its stage's layers (:meth:`PipelineStack.
keep_stage`). :meth:`PipelineStack.load_stacked` and
:meth:`PipelineStack.stacked_tree` carry weights to and from JAX's
stacked leaves (``stack__<leaf with dots as __>``); the schedules are
``parallel.schedules``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import schedules


# -- layer descriptors (API of pp_layers.py) ------------------------------------

class LayerDesc:
    """Deferred construction of an ``nn.Module`` (reference:
    pp_layers.py LayerDesc:56)."""

    def __init__(self, layer_cls, *args, **kwargs):
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, nn.Module)):
            raise TypeError(f"LayerDesc expects an nn.Module subclass, got "
                            f"{layer_cls}")
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self) -> nn.Module:
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer whose parameters are shared across stages (reference:
    pp_layers.py SharedLayerDesc:76; tied embeddings). It is built once,
    outside the pipelined run; ``key`` records the tie."""

    def __init__(self, key: str, layer_cls, *args,
                 forward_func: Optional[Callable] = None, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key
        self.forward_func = forward_func


class SegmentLayers:
    """Partition a list of layer descs into pipeline stages (reference:
    pp_layers.py SegmentLayers:92): "uniform" (even by count) or
    "layer:<ClassName>" (even by occurrences of a class, the layers
    before and after staying with the first and last stage)."""

    def __init__(self, layers: Sequence, num_parts: int,
                 method: str = "uniform"):
        self.layers = list(layers)
        self.num_parts = num_parts
        self.method = method
        if len(self.layers) < num_parts:
            raise ValueError(f"cannot split {len(self.layers)} layers into "
                             f"{num_parts} stages")

    def do_segment(self) -> List[int]:
        """Stage boundaries: a list of num_parts + 1 indices."""
        if self.method == "uniform":
            return self._uniform(len(self.layers), self.num_parts)
        if self.method.startswith("layer:"):
            name = self.method.split(":", 1)[1]
            marks = [i for i, lyr in enumerate(self.layers)
                     if self._type_name(lyr) == name]
            if len(marks) < self.num_parts:
                raise ValueError(f"only {len(marks)} '{name}' layers for "
                                 f"{self.num_parts} stages")
            part = self._uniform(len(marks), self.num_parts)
            bounds = [0] * (self.num_parts + 1)
            for p in range(1, self.num_parts):
                bounds[p] = marks[part[p]]
            bounds[self.num_parts] = len(self.layers)
            return bounds
        raise ValueError(f"unknown segment method {self.method!r}")

    @staticmethod
    def _uniform(n: int, parts: int) -> List[int]:
        base, rem = divmod(n, parts)
        bounds = [0]
        for p in range(parts):
            bounds.append(bounds[-1] + base + (1 if p < rem else 0))
        return bounds

    @staticmethod
    def _type_name(lyr) -> str:
        if isinstance(lyr, LayerDesc):
            return lyr.layer_cls.__name__
        return type(lyr).__name__


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by {num_microbatches} "
                         f"microbatches")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def jax_leaf_name(leaf: str) -> str:
    """The JAX stack's parameter name of a layer's parameter ``leaf``."""
    return "stack__" + leaf.replace(".", "__")


# -- the pipelined stack ---------------------------------------------------------

class PipelineStack(nn.Module):
    """``num_layers`` identical layers (``make_layer()`` each, drawn in
    order) run as a pipeline. ``forward(h, *extras)`` applies every layer
    as ``layer(h, *extras)``: in sequence when ``num_stages`` is 1 (each
    layer checkpointed under ``remat``), else over
    ``num_microbatches`` microbatches by the GPipe or the interleaved
    schedule (``schedule`` "1f1b" forwards as GPipe: its memory profile
    is the fused step's, the owning model's ``loss_and_grads``)."""

    SCHEDULES = ("gpipe", "1f1b", "interleaved")

    def __init__(self, make_layer: Callable[[], nn.Module], num_layers: int,
                 num_stages: int = 1, num_microbatches: int = 1,
                 remat: bool = True, schedule: str = "gpipe",
                 num_chunks: int = 1):
        super().__init__()
        if schedule not in self.SCHEDULES:
            raise ValueError(f"schedule must be one of {self.SCHEDULES}, "
                             f"got {schedule!r}")
        if schedule == "interleaved" and num_chunks < 2:
            raise ValueError("interleaved schedule needs num_chunks >= 2")
        if schedule != "interleaved":
            num_chunks = 1
        if num_layers % max(num_stages * num_chunks, 1):
            raise ValueError(f"num_layers={num_layers} must be divisible by "
                             f"num_stages*num_chunks="
                             f"{num_stages * num_chunks}")
        if (schedule == "interleaved" and num_stages > 1
                and num_microbatches % num_stages):
            raise ValueError(f"interleaved schedule needs num_microbatches="
                             f"{num_microbatches} divisible by num_stages="
                             f"{num_stages}")
        self.num_layers = num_layers
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.remat = remat
        self.schedule = schedule
        self.num_chunks = num_chunks
        # a ModuleDict keyed by the global layer index: the names of a
        # ModuleList, which survive dropping other stages' layers
        self.layers = nn.ModuleDict({str(i): make_layer()
                                     for i in range(num_layers)})
        self._leaf_names = [n for n, _ in self.layers["0"].named_parameters()]
        #: the pp runtime of a sharded stack (VIRTUAL: every stage here)
        self.runtime: schedules.Runtime = schedules.VIRTUAL

    # -- placement -------------------------------------------------------------

    @property
    def per_stage(self) -> int:
        """k: layers per virtual stage."""
        return self.num_layers // (self.num_stages * self.num_chunks)

    def virtual_layers(self, vs: int) -> range:
        k = self.per_stage
        return range(vs * k, (vs + 1) * k)

    def stage_of(self, i: int) -> int:
        """The (physical) stage holding layer i."""
        return (i // self.per_stage) % self.num_stages

    def keep_stage(self, stage: int, runtime: schedules.Runtime) -> None:
        """Drop every layer but stage ``stage``'s (this rank's on a pp
        mesh) and run the schedules through ``runtime``."""
        for i in range(self.num_layers):
            if self.stage_of(i) != stage and str(i) in self.layers:
                del self.layers[str(i)]
        self.runtime = runtime

    def stage_fn(self, *extras) -> Callable:
        """fn(vs, h): virtual stage vs's layers applied to h."""
        def fn(vs, h):
            for i in self.virtual_layers(vs):
                h = self.layers[str(i)](h, *extras)
            return h
        return fn

    # -- JAX's stacked leaves --------------------------------------------------

    def pack_leaf(self, stacked: torch.Tensor) -> torch.Tensor:
        """[L, ...] layer-stacked leaf -> JAX's storage layout ([V, S, k,
        ...] for the interleaved schedule)."""
        if self.schedule != "interleaved":
            return stacked
        V, S = self.num_chunks, self.num_stages
        return stacked.reshape((V, S, self.per_stage)
                               + tuple(stacked.shape[1:]))

    def unpack_leaf(self, stored: torch.Tensor) -> torch.Tensor:
        """JAX's storage layout -> [L, ...] in layer order."""
        if self.schedule != "interleaved":
            return stored
        return stored.reshape((self.num_layers,) + tuple(stored.shape[3:]))

    @torch.no_grad()
    def load_stacked(self, tree: Dict[str, torch.Tensor]) -> None:
        """Copy JAX's stacked leaves (``{"stack__<leaf>": [L, ...] or
        [V, S, k, ...]}``, the stack's own names) into the layers held
        here."""
        for leaf in self._leaf_names:
            full = self.unpack_leaf(torch.as_tensor(tree[jax_leaf_name(leaf)]))
            for key, layer in self.layers.items():
                p = layer.get_parameter(leaf)
                p.copy_(full[int(key)].to(p.dtype))

    def stacked_tree(self, grads: bool = False) -> Dict[str, torch.Tensor]:
        """The parameters (or their gradients) of every layer, stacked as
        JAX stores them. Needs every layer (not on a pp mesh)."""
        out = {}
        for leaf in self._leaf_names:
            ts = []
            for i in range(self.num_layers):
                p = self.layers[str(i)].get_parameter(leaf)
                ts.append((p.grad if grads else p).detach())
            out[jax_leaf_name(leaf)] = self.pack_leaf(torch.stack(ts))
        return out

    # -- forward ---------------------------------------------------------------

    def forward(self, h: torch.Tensor, *extras) -> torch.Tensor:
        if self.num_stages <= 1:
            for i in range(self.num_layers):
                layer = self.layers[str(i)]
                h = (checkpoint(layer, h, *extras, use_reentrant=False)
                     if self.remat and torch.is_grad_enabled()
                     else layer(h, *extras))
            return h
        xmb = microbatch(h, self.num_microbatches)
        fn = self.stage_fn(*extras)
        if self.schedule == "interleaved":
            out = schedules.pipeline_interleaved(
                fn, xmb, num_stages=self.num_stages,
                num_chunks=self.num_chunks, remat=self.remat,
                runtime=self.runtime)
        else:
            out = schedules.pipeline_gpipe(
                fn, xmb, num_stages=self.num_stages, remat=self.remat,
                runtime=self.runtime)
        return None if out is None else unmicrobatch(out)


class PipelineLayer(nn.Module):
    """Desc-based pipeline model (reference: pp_layers.py
    PipelineLayer:237). The longest homogeneous run of LayerDescs (same
    class, arguments and keywords; at least ``num_stages`` of them and a
    multiple of it) becomes a :class:`PipelineStack`; the layers before
    and after it (embedding, final norm, head) run whole, outside the
    pipeline. ``forward(x, *extras)`` passes ``extras`` to the stack
    only."""

    def __init__(self, layers: Sequence, num_stages: int = 1,
                 num_microbatches: int = 1,
                 loss_fn: Optional[Callable] = None,
                 seg_method: str = "uniform", recompute_interval: int = 0):
        super().__init__()
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.loss_fn = loss_fn
        self._order: List[str] = []
        descs = list(layers)

        def plain(d):
            return isinstance(d, LayerDesc) and not isinstance(
                d, SharedLayerDesc)
        best = (0, 0)
        i = 0
        while i < len(descs):
            if not plain(descs[i]):
                i += 1
                continue
            j = i
            while (j < len(descs) and plain(descs[j])
                   and descs[j].layer_cls is descs[i].layer_cls
                   and descs[j].args == descs[i].args
                   and descs[j].kwargs == descs[i].kwargs):
                j += 1
            if j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        run_start, run_end = best
        run_len = run_end - run_start
        use_pipe = (run_len >= num_stages and num_stages > 1
                    and run_len % num_stages == 0)
        idx = 0
        for pos, d in enumerate(descs):
            if use_pipe and run_start < pos < run_end:
                continue
            if use_pipe and pos == run_start:
                lyr = PipelineStack(lambda dd=d: dd.build(),
                                    num_layers=run_len,
                                    num_stages=num_stages,
                                    num_microbatches=num_microbatches,
                                    remat=recompute_interval > 0)
            else:
                lyr = d.build() if isinstance(d, LayerDesc) else d
            name = f"seg_{idx}"
            setattr(self, name, lyr)
            self._order.append(name)
            idx += 1

    def forward(self, x, *extras):
        for name in self._order:
            lyr = getattr(self, name)
            x = lyr(x, *extras) if isinstance(lyr, PipelineStack) else lyr(x)
        return x


__all__ = ["LayerDesc", "SharedLayerDesc", "SegmentLayers", "PipelineStack",
           "PipelineLayer", "microbatch", "unmicrobatch", "jax_leaf_name"]
