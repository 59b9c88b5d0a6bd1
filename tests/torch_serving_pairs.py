"""Shared by the port's engine, handoff and fabric parity tests: the tiny
Llama of the JAX package and the port's copy of it (weights carried by
``convert.py``), each with its int8 twin, and the reuse of the JAX
engines' lazily built jit functions across engines of one model."""

import numpy as np

from paddle_tpu.quantization import quantize_model as jax_quantize_model
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.quantization import quantize_model

# JAX engine functions that close over the model only (not over the
# engine's pools or tables), so engines of one model can share them
_JAX_FNS = ("_chunk_fn", "_tail_fn", "_gather_fn", "_scatter_fn",
            "_cow_fn", "_act_fn", "_deact_fn", "_hist_set_fn")
_JAX_FN_CACHE = {}


def model_pairs(tiny_llama, int8: bool = True):
    """{"native": (jax model, port model), "int8": (...)} on the CPU (the
    int8 pair only when ``int8``)."""
    cfg = LlamaConfig.tiny()
    port = LlamaForCausalLM(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in tiny_llama.state_dict().items()}, cfg,
        device="cpu"))
    out = {"native": (tiny_llama, port)}
    if int8:
        out["int8"] = (jax_quantize_model(tiny_llama, kv_dtype="int8"),
                       quantize_model(port, kv_dtype="int8"))
    return out


def share_jax_fns(engines):
    """Give JAX ``engines`` the jit functions an earlier engine of the
    same model built (each engine would otherwise compile its own)."""
    for e in engines:
        for a in _JAX_FNS:
            fn = _JAX_FN_CACHE.get((id(e.model), e.kv_quant, a))
            if fn is not None and getattr(e, a, None) is None:
                setattr(e, a, fn)


def keep_jax_fns(engines):
    """Remember the jit functions ``engines`` built, for share_jax_fns."""
    for e in engines:
        for a in _JAX_FNS:
            fn = getattr(e, a, None)
            if fn is not None:
                _JAX_FN_CACHE.setdefault((id(e.model), e.kv_quant, a), fn)


# -- the engine-feature tests' traffic (test_torch_serving_features.py and
# test_torch_serving_safety.py) ----------------------------------------------

FEATURE_PAGE = 8
FEATURE_NEW = 9


def feature_family(seed=31):
    """Five prompts sharing a 19-token prefix (two whole pages and three
    tokens) and one cold prompt."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 512, (2 * FEATURE_PAGE + 3,))
    fam = [np.concatenate([shared, rs.randint(0, 512, (t,))])
           for t in (3, 5, 2, 7, 12)]
    return fam + [rs.randint(0, 512, (11,))]


def feature_engine(model, **feats):
    """The port's engine of the feature tests: 3 slots, page 8, 64
    positions, 9 new tokens."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    return ContinuousBatchingEngine(
        model, max_batch=3, page_size=FEATURE_PAGE, max_len=64,
        generation_config=GenerationConfig(max_new_tokens=FEATURE_NEW),
        **feats)
