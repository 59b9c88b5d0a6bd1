"""Scale fit: does a (model, mesh, batch) configuration fit the card's
memory? (counterpart of ``paddle_tpu/parallel/scale.py``).

Reference analogue: the auto-tuner's memory pruner
(python/paddle/distributed/auto_tuner/prune.py
prune_by_memory_estimation), computed here from the model's own
parameter tree and sharding table instead of a closed form. The model is
built on ``torch.device("meta")`` (shapes and dtypes, no storage: a 70B
model is never materialised), and the mesh is :func:`abstract_mesh`, a
device-free mesh of degrees that ``parallel.api``'s spec cleaning
accepts. The arithmetic is JAX's.

A pipeline model (one with ``param_stage``) on a ``pp`` axis holds one
stage's decoder layers a rank; its embedding, head and final norm are
counted on every rank, as JAX's stacked layout places them (the port's
first and last stages hold a part each, so that count is an upper
bound).

Memory: :data:`HBM_GB` (the H100 80GB HBM3's data sheet).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

HBM_GB = {"h100": 80.0}

_OPT_BYTES_PER_PARAM = 12  # AdamW fp32 master + m + v


class AbstractMesh:
    """A mesh of named degrees with no devices and no process group:
    what ``parallel.api._clean_spec`` asks of a mesh (``axis_size``)."""

    def __init__(self, axes: Dict[str, int]):
        self.shape = {n: int(s) for n, s in axes.items()}
        self.axes = tuple(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def abstract_mesh(axes: Dict[str, int]) -> AbstractMesh:
    """The mesh of {'pp': 4, 'fsdp': 2, 'tp': 8}: no devices needed."""
    return AbstractMesh(axes)


def clean_spec(sharding: Optional[Tuple], axes: Dict[str, int]) -> Tuple:
    """The spec without the axes the mesh lacks or holds at size 1: the
    one implementation in ``parallel.api``; () when replicated."""
    from .api import _clean_spec
    if sharding is None:
        return ()
    return _clean_spec(sharding, abstract_mesh(axes))


def _shard_shape(shape, spec, mesh: AbstractMesh) -> Tuple[int, ...]:
    """The per-device shard of ``shape`` under ``spec``; every split must
    divide its dimension (JAX's ``NamedSharding.shard_shape`` raises
    otherwise, and so does this)."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        names = () if e is None else (e,) if isinstance(e, str) else e
        k = int(np.prod([mesh.axis_size(a) for a in names] or [1]))
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {names} ({k} shards)")
        out.append(n // k)
    return tuple(out)


def param_plan(model, axes: Dict[str, int]):
    """Yields (name, param, spec, local_shape) for every parameter, where
    local_shape is the per-device shard under the cleaned spec. On a
    ``pp`` axis a pipeline model's decoder-layer parameters lead their
    spec with "pp": one stage's layers are local (the first stage's),
    the others' local shape is empty."""
    mesh = abstract_mesh(axes)
    ann = dict(getattr(model, "_sharding_annotations", {}))
    stage_of = getattr(model, "param_stage", None)
    pp = mesh.axis_size("pp")
    if stage_of is not None and pp > 1 and model.num_stages != pp:
        raise ValueError(f"a {model.num_stages}-stage pipeline on pp={pp}")
    for name, p in model.named_parameters():
        spec = clean_spec(ann.get(name, (None, None))[0], axes)
        local = _shard_shape(tuple(p.shape), spec, mesh)
        if stage_of is not None and pp > 1 and name.startswith(
                "decoder.layers."):
            spec = ("pp",) + tuple(spec)
            if stage_of(name) != 0:
                local = (0,) * len(local)
        yield name, p, spec, local


def train_state_bytes(model, axes: Dict[str, int], *, seq_len: int,
                      microbatch_size: int, recompute: str = "full",
                      vocab_size: Optional[int] = None,
                      hidden_size: Optional[int] = None,
                      num_layers: Optional[int] = None) -> Dict[str, float]:
    """Per-device training-state memory (bytes) of the model on a mesh.

    Parameters and gradients take each parameter's own dtype; the
    optimizer state is an fp32 master and two moments (12 B a
    parameter); activations follow the Megatron per-layer formula scaled
    by the microbatch, tp and sequence sharding, ``recompute`` choosing
    how many layers stay live (full: 1 live layer and the boundary
    saves; none: every local layer)."""
    cfg = getattr(model, "cfg", None)
    vocab = vocab_size or getattr(cfg, "vocab_size", 0)
    h = hidden_size or getattr(cfg, "hidden_size", 0)
    layers = num_layers or getattr(cfg, "num_hidden_layers", 0)

    p_bytes = g_bytes = o_bytes = 0.0
    n_params = 0
    for name, p, spec, local in param_plan(model, axes):
        n_local = int(np.prod(local))
        n_params += p.numel()
        p_bytes += n_local * p.element_size()
        g_bytes += n_local * p.element_size()
        o_bytes += n_local * _OPT_BYTES_PER_PARAM

    tp = axes.get("tp", 1)
    sp = axes.get("sep", 1)
    pp = axes.get("pp", 1)
    b, s = microbatch_size, seq_len
    layers_local = max(layers / pp, 1)
    # Megatron's activation memory, bf16: ~34*s*b*h bytes a layer for one
    # microbatch; tensor and sequence parallelism both divide it
    act_layer = s * b * h * 34 / (tp * sp)
    # a pipeline keeps up to min(M, 2*pp-1) microbatch stage inputs live
    # a stage (the 1F1B ring); pp=1 holds 1
    micro = getattr(model, "num_microbatches", 1) or 1
    in_flight = min(micro, 2 * pp - 1) if pp > 1 else 1
    boundary = s * b * h * 2 / sp            # one bf16 stage/layer input
    if recompute == "full":
        act = act_layer + layers_local * boundary + in_flight * boundary
    elif recompute == "selective":
        act = act_layer * max(layers_local / 4, 1) + in_flight * boundary
    else:
        act = act_layer * layers_local * in_flight
    # the fp32 logits of the CE head on the last stage
    act += s * b * (vocab / tp) * 4

    total = p_bytes + g_bytes + o_bytes + act
    return {"params": p_bytes, "grads": g_bytes, "optimizer": o_bytes,
            "activations": act, "total": total, "n_params": n_params,
            "total_gb": total / 1e9}


def fits(model, axes: Dict[str, int], *, seq_len: int, microbatch_size: int,
         device: str = "h100", recompute: str = "full",
         headroom: float = 0.85) -> Tuple[bool, Dict[str, float]]:
    """(fits, breakdown): the per-device state must stay under
    ``headroom`` × the card's memory."""
    br = train_state_bytes(model, axes, seq_len=seq_len,
                           microbatch_size=microbatch_size,
                           recompute=recompute)
    budget = HBM_GB[device] * 1e9 * headroom
    br["budget_gb"] = budget / 1e9
    br["device"] = device
    return br["total"] <= budget, br


__all__ = ["abstract_mesh", "AbstractMesh", "clean_spec", "param_plan",
           "train_state_bytes", "fits", "HBM_GB"]
