"""The port's Llama (paddle_tpu_torch.models.llama) against the JAX
package's on the CPU: the same tiny model, weights carried across by
``state_dict_from_jax``, the same inputs from numpy. fp32; logits,
hidden states and K/V pools within 1e-4 (two frameworks' matmul and
reduction orders through two layers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

TOL = 1e-4
PAGE = 8


@pytest.fixture(scope="module")
def pair(tiny_llama):
    cfg = LlamaConfig.tiny()
    sd = {k: np.asarray(v) for k, v in tiny_llama.state_dict().items()}
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(sd, cfg, device="cpu"))
    return tiny_llama, model


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def test_forward_logits_match(pair):
    jm, tm = pair
    ids = np.random.RandomState(0).randint(0, 512, (2, 13))
    with torch.inference_mode():
        got = tm(torch.tensor(ids))
    _close(got, jm(jnp.asarray(ids)))


def test_paged_prefill_and_decode_match(pair):
    """prefill_paged hidden states and pools, then three
    decode_step_paged steps, against the JAX model step for step."""
    jm, tm = pair
    rs = np.random.RandomState(1)
    b, s = 2, 11                         # s crosses a page boundary
    ids = rs.randint(0, 512, (b, s))
    jpools, jtables = jm.model.alloc_paged_caches(b, 32, PAGE)
    tpools, ttables = tm.model.alloc_paged_caches(b, 32, PAGE)
    np.testing.assert_array_equal(ttables.numpy(), np.asarray(jtables))
    with torch.inference_mode():
        th, tpools = tm.model.prefill_paged(torch.tensor(ids), tpools,
                                            ttables)
    jh, jpools = jm.model.prefill_paged(jnp.asarray(ids), jpools, jtables)
    _close(th, jh)
    for (tk, tv), (jk, jv) in zip(tpools, jpools):
        _close(tk, jk)
        _close(tv, jv)
    pos = np.array([s, s - 3])
    for step in range(3):
        tok = rs.randint(0, 512, (b,))
        with torch.inference_mode():
            th, tpools = tm.model.decode_step_paged(
                torch.tensor(tok), torch.tensor(pos), tpools, ttables)
            tl = tm.logits(th[:, 0])
        jh, jpools = jm.model.decode_step_paged(
            jnp.asarray(tok), jnp.asarray(pos, jnp.int32), jpools, jtables)
        _close(th, jh)
        _close(tl, jm.logits(jh[:, 0]))
        pos = pos + 1
    for (tk, tv), (jk, jv) in zip(tpools, jpools):
        _close(tk, jk)
        _close(tv, jv)


def test_tied_embeddings_logits_match():
    import paddle_tpu as pt
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    pt.seed(3)
    jm = JaxLlama(JaxConfig.tiny(tie_word_embeddings=True,
                                 num_hidden_layers=1))
    cfg = LlamaConfig.tiny(tie_word_embeddings=True, num_hidden_layers=1)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}, cfg,
        device="cpu"))
    ids = np.random.RandomState(2).randint(0, 512, (1, 9))
    with torch.inference_mode():
        got = tm(torch.tensor(ids))
    _close(got, jm(jnp.asarray(ids)))


def test_state_dict_from_jax_names_bad_keys(tiny_llama):
    cfg = LlamaConfig.tiny()
    sd = {k: np.asarray(v) for k, v in tiny_llama.state_dict().items()}
    sd.pop("model.norm.weight")
    sd["model.extra"] = np.zeros(3, np.float32)
    sd["lm_head"] = sd["lm_head"][:, :10]
    with pytest.raises(ValueError) as e:
        state_dict_from_jax(sd, cfg, device="cpu")
    msg = str(e.value)
    assert "model.norm.weight" in msg and "model.extra" in msg \
        and "lm_head" in msg


def test_generator_makes_weights_reproducible():
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    a = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    b = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    for (na, ta), (nb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    assert a.model.norm.weight.dtype == torch.float32
    bf = LlamaForCausalLM(cfg, device="cpu", dtype="bfloat16")
    assert bf.lm_head.dtype == torch.bfloat16
    assert bf.model.layers[0].input_layernorm.weight.dtype == torch.float32
