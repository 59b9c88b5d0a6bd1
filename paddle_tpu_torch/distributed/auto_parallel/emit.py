"""Plan emission: the winning config as a concrete, serializable layout
(counterpart of ``paddle_tpu/distributed/auto_parallel/emit.py``).

A :class:`ShardingPlan` is a dumb artifact: mesh axis sizes, a
name → spec table in the JAX layout (the JAX package's
``param_spec_tree``, equal to the port's), and the batch spec. Its
``as_dict()`` is byte-for-byte the JAX package's for the same config and
model, so ``_PLAN.json`` sidecars and plan artifacts cross frameworks;
a pipeline config's table names JAX's stacked leaves
(``decoder.stack__<leaf>``).

``apply`` realizes the table through the port's own placement,
``parallel.api.shard_layer`` (fused ``qkv_proj`` / ``gate_up_proj``
split per part, KV heads replicated when tp exceeds them) and, with an
fsdp axis, FSDP2 (``group_sharded_parallel``'s "p_g_os"), after holding
the model's own spec table to the plan's: a plan emitted for another
architecture, or a spec the placement would not realize, raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

__all__ = ["ShardingPlan", "emit_plan", "plan_for_config"]


def _spec_to_json(spec) -> List:
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            # a one-axis entry reads as its axis, as a PartitionSpec
            # canonicalises it
            out.append(e[0] if len(e) == 1 else list(e))
        else:
            out.append(e)
    return out


def _spec_from_json(entries) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def _size(axes: Dict[str, int]) -> int:
    n = 1
    for v in axes.values():
        n *= int(v)
    return n


@dataclass
class ShardingPlan:
    """One emitted plan: mesh axis sizes + parameter/batch specs."""
    config_str: str
    axes: Dict[str, int]                     # mesh sizes (dp already /ep)
    batch_spec: tuple
    param_specs: Dict[str, tuple]            # name -> spec (JAX layout)
    sequence_parallel: bool = False
    notes: str = ""

    @property
    def size(self) -> int:
        return _size(self.axes)

    # -- construction --------------------------------------------------------

    def build_mesh(self, devices=None):
        """The ``HybridMesh`` of this plan over the live world
        (``torch.distributed``, initialised); raises when the world's
        size is not the plan's. ``devices``: the mesh's device type."""
        import torch.distributed as dist
        from ...parallel.mesh import HybridMesh
        if not dist.is_initialized():
            raise RuntimeError(
                f"ShardingPlan({self.config_str}).build_mesh needs the "
                f"process group of its {self.size} ranks: call "
                f"init_parallel_env first")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(
                f"ShardingPlan({self.config_str}) spans {self.size} ranks "
                f"but the world has {world}: re-plan for {world} "
                f"(auto_parallel.plan) instead of applying this one")
        ep = int(self.axes.get("ep", 1))
        return HybridMesh.build(
            dp=int(self.axes.get("dp", 1)) * ep,
            fsdp=int(self.axes.get("fsdp", 1)),
            tp=int(self.axes.get("tp", 1)), pp=int(self.axes.get("pp", 1)),
            sep=int(self.axes.get("sep", 1)), ep=ep, devices=devices)

    # -- application ---------------------------------------------------------

    def check_model(self, model, hm) -> None:
        """Raise unless ``model``'s own spec table on ``hm`` is the
        plan's: most names present (else the plan was emitted for another
        architecture) and every shared name's spec equal."""
        mine = _jax_specs(model, hm)
        names = list(mine)
        if self.param_specs and names:
            matched = set(self.param_specs) & set(names)
            if len(matched) * 2 < len(names):
                missing = sorted(set(names) - set(self.param_specs))[:3]
                raise ValueError(
                    f"ShardingPlan({self.config_str}): only "
                    f"{len(matched)}/{len(names)} parameters of "
                    f"{type(model).__name__} appear in the plan's name "
                    f"table (e.g. missing {missing}) — the plan was "
                    f"emitted for a different model class/architecture "
                    f"and would silently replicate everything; re-plan "
                    f"for this model instead of applying a mismatched "
                    f"artifact")
        bad = [(n, self.param_specs[n], mine[n]) for n in names
               if n in self.param_specs
               and _spec_to_json(self.param_specs[n])
               != _spec_to_json(mine[n])]
        if bad:
            raise ValueError(
                f"ShardingPlan({self.config_str}): the placement would not "
                f"realise the plan's specs (name, plan, model): {bad[:3]}")

    def apply(self, model, mesh=None, devices=None):
        """Shard ``model`` (each rank holding the same full weights) as
        the plan says, in place, and return the mesh (not entered):
        ``shard_layer``, then FSDP2 over an fsdp axis. Buffers stay
        replicated."""
        from ...parallel.api import mesh_plan_of, shard_layer
        from ..sharding import shard_model
        hm = mesh if mesh is not None else self.build_mesh(devices)
        if mesh_plan_of(model) is not None:
            raise RuntimeError(f"ShardingPlan({self.config_str}).apply: the "
                               f"model is already sharded")
        self.check_model(model, hm)
        shard_layer(model, hm)
        if hm.axis_size("fsdp") > 1:
            shard_model(model, "p_g_os", hm)
        return hm

    def shard_batch(self, batch: Dict, mesh=None) -> Dict:
        """This rank's slice of a GLOBAL batch per the batch spec: rows
        over the data axes and, with sequence parallelism, the sequence
        over sep (``MeshPlan.local_batch``'s cut; the Trainer takes the
        global batch and cuts it itself)."""
        from ...parallel.mesh import BATCH_AXES, current_mesh
        hm = mesh if mesh is not None else current_mesh()
        if hm is None:
            hm = self.build_mesh()
        nb, ib = hm.group_size(BATCH_AXES), hm.group_rank(BATCH_AXES)
        sep, isep = hm.axis_size("sep"), hm.coordinate("sep")
        out = {}
        for k, v in batch.items():
            if nb > 1:
                v = v.chunk(nb, dim=0)[ib]
            if self.sequence_parallel and sep > 1 and v.dim() > 1:
                v = v.chunk(sep, dim=1)[isep]
            out[k] = v
        return out

    # -- serialization -------------------------------------------------------

    def as_dict(self) -> Dict:
        return {"config": self.config_str, "axes": dict(self.axes),
                "batch_spec": _spec_to_json(self.batch_spec),
                "sequence_parallel": self.sequence_parallel,
                "param_specs": {k: _spec_to_json(v)
                                for k, v in self.param_specs.items()},
                "notes": self.notes}

    @staticmethod
    def from_dict(d: Dict) -> "ShardingPlan":
        return ShardingPlan(
            config_str=d["config"], axes=dict(d["axes"]),
            batch_spec=_spec_from_json(d["batch_spec"]),
            param_specs={k: _spec_from_json(v)
                         for k, v in d["param_specs"].items()},
            sequence_parallel=bool(d.get("sequence_parallel", False)),
            notes=d.get("notes", ""))


class _Axes:
    """Mesh axis sizes with the two queries spec cleaning asks of a
    mesh (``shape``, ``axis_size``): a plan is emitted without one."""

    def __init__(self, axes: Dict[str, int]):
        self.shape = {a: int(n) for a, n in axes.items()}

    def axis_size(self, a: str) -> int:
        return self.shape.get(a, 1)


def _clean(entries, axes: Dict[str, int]) -> tuple:
    from ...parallel.api import _clean_spec
    return _clean_spec(entries, _Axes(axes))


def _jax_specs(model, hm) -> Dict[str, tuple]:
    """The JAX package's ``param_spec_tree`` of ``model`` on ``hm``: the
    port's, but for a pipeline model whose layers JAX stacks
    (``decoder.stack__<leaf>``, a leading "pp" dimension)."""
    from ...parallel.api import param_spec_tree
    if not hasattr(model, "full_shapes"):
        return dict(param_spec_tree(model, hm))
    from ...models.llama import parameter_shapes, sharding_annotations
    from ...parallel.pipeline import jax_leaf_name
    ann = sharding_annotations(model.cfg)
    shapes = parameter_shapes(model.cfg)
    out: Dict[str, tuple] = {}
    rename = {"model.embed_tokens": "embed_tokens", "lm_head": "lm_head"}
    for name, (spec, _blocks) in ann.items():
        if name in rename:
            out[rename[name]] = _clean(spec, hm.shape)
    for name, (spec, _blocks) in ann.items():
        if name.startswith("model.layers.0."):
            leaf = name[len("model.layers.0."):]
            nd = len(shapes[name][0])
            out["decoder." + jax_leaf_name(leaf)] = _clean(
                ("pp",) + tuple(spec or (None,) * nd), hm.shape)
    out["norm.weight"] = _clean(ann["model.norm.weight"][0], hm.shape)
    return out


def emit_plan(model, mesh, config) -> ShardingPlan:
    """Freeze ``model``'s per-parameter specs on ``mesh`` (a
    ``HybridMesh``, or a dict of axis sizes) into a plan artifact."""
    axes = dict(mesh) if isinstance(mesh, dict) else {
        a: int(mesh.shape[a]) for a in mesh.axes}
    batch_spec = _clean([("dp", "ep", "fsdp"), None], axes)
    return ShardingPlan(
        config_str=str(config), axes=axes, batch_spec=batch_spec,
        param_specs=_jax_specs(model, _Axes(axes)),
        sequence_parallel=bool(getattr(config, "sep", 1) > 1),
        notes=f"emitted for {config}")


def mesh_axes(config) -> Dict[str, int]:
    """The mesh sizes of a config, in the mesh's axis order: ``dp`` is
    ``dp / ep`` on an ep mesh, which gains an ``ep`` axis."""
    from ...parallel.mesh import AXES_ORDER, AXES_ORDER_EP
    ep = int(getattr(config, "ep", 1))
    sizes = {"pp": int(getattr(config, "pp", 1)), "dp": int(config.dp),
             "fsdp": int(getattr(config, "fsdp", 1)),
             "sep": int(getattr(config, "sep", 1)), "tp": int(config.tp)}
    if ep > 1:
        sizes["dp"] //= ep
        sizes["ep"] = ep
        return {a: sizes[a] for a in AXES_ORDER_EP}
    return {a: sizes[a] for a in AXES_ORDER}


def plan_for_config(model_cfg, config, devices=None) -> ShardingPlan:
    """Emit the plan for ``config`` WITHOUT pricing: the model is built
    on the ``meta`` device (shapes only, no weights, no process group)
    and its specs frozen on the config's mesh sizes. Used where the
    winner is already known — the elastic resume re-applying a chosen
    config, the reshard CLI. ``devices`` is accepted for the JAX
    signature and unused."""
    import dataclasses
    from ...models.llama import LlamaForCausalLM, LlamaForCausalLMPipe
    from ...models.moe_lm import MoEForCausalLM
    sep = int(getattr(config, "sep", 1))
    is_moe = bool(getattr(model_cfg, "num_experts", 0))
    mcfg = model_cfg if is_moe else dataclasses.replace(
        model_cfg, sequence_parallel=sep > 1)
    if int(getattr(config, "pp", 1)) > 1:
        model = LlamaForCausalLMPipe(mcfg, num_stages=int(config.pp),
                                     num_microbatches=2, device="meta")
    elif is_moe:
        model = MoEForCausalLM(mcfg, device="meta")
    else:
        model = LlamaForCausalLM(mcfg, device="meta")
    return emit_plan(model, mesh_axes(config), config)
