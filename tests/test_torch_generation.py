"""The port's one-shot generation (paddle_tpu_torch.inference.generation)
against the JAX package's on the CPU, over the tiny Llama and its int8
twin (``tests/torch_serving_pairs.py``): the dense KV caches of
``prefill`` and teacher-forced ``decode_step`` hiddens, the greedy
tokens of ``generate`` / ``generate_scan`` / ``generate_paged`` (page 8,
prompts of 8 and 5 tokens, the decode crossing a page), EOS and pad,
the scalar sampling mask against JAX's ``_mask_logits_rowwise``, and the
sampled streams' replay. Inputs come from numpy with a fixed seed, fp32.

Tolerances: caches and hiddens 1e-5 (the same fp32 arithmetic in
another summation order, two layers); tokens exactly. Sampled tokens are
the port's own streams (row_uniforms, not JAX's threefry keys), so they
are held to the port's other generators, not to JAX."""

import numpy as np
import pytest
import torch

from paddle_tpu.inference import generation as jgen
from paddle_tpu_torch.inference import generation as gen
from torch_serving_pairs import model_pairs

PAGE = 8
NEW = 6
# name: (rows, prompt tokens); 5 + 6 and 8 + 6 both cross the page edge
SHAPES = {"p8": (2, 8), "p5": (2, 5)}
ENTRIES = ("generate", "generate_scan", "generate_paged")
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9, seed=3)


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(
        np.int32)


def _drive(mod, name, model, ids, cfg):
    kw = {"page_size": PAGE} if name == "generate_paged" else {}
    return np.asarray(getattr(mod, name)(model, ids, cfg, **kw))


@pytest.fixture(scope="module")
def pairs(tiny_llama):
    return model_pairs(tiny_llama)


@pytest.fixture(scope="module")
def jax_tokens(pairs):
    """JAX's greedy tokens of every entry, per (model, shape)."""
    cfg = jgen.GenerationConfig(max_new_tokens=NEW)
    return {(kind, shape, d): _drive(jgen, d, jm, _ids(*SHAPES[shape]), cfg)
            for kind, (jm, _) in pairs.items()
            for shape in SHAPES for d in ENTRIES}


@pytest.mark.parametrize("kind", ["native", "int8"])
def test_prefill_caches_and_decode_hiddens_match_jax(pairs, kind):
    jm, pm = pairs[kind]
    ids = _ids(2, 8)
    ref_h, ref_c = jm.model.prefill(ids, 12)
    with torch.inference_mode():
        h, caches = pm.model.prefill(torch.as_tensor(ids).long(), 12)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5,
                               atol=1e-5)
    for (k, v), (rk, rv) in zip(caches, ref_c):
        assert k.shape == tuple(rk.shape) and k.dtype == torch.float32
        np.testing.assert_allclose(k.numpy(), np.asarray(rk), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5,
                                   atol=1e-5)
    nxt = _ids(2, 3, seed=1)
    for t in range(3):
        pos = np.full((2,), 8 + t, np.int32)
        ref_h, ref_c = jm.model.decode_step(nxt[:, t], pos, ref_c)
        with torch.inference_mode():
            h, caches = pm.model.decode_step(
                torch.as_tensor(nxt[:, t]).long(),
                torch.as_tensor(pos).long(), caches)
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["native", "int8"])
def test_greedy_tokens_equal_jax(pairs, jax_tokens, kind, shape, entry):
    ids = _ids(*SHAPES[shape])
    got = _drive(gen, entry, pairs[kind][1], ids,
                 gen.GenerationConfig(max_new_tokens=NEW))
    assert got.dtype == np.int32 and got.shape == (ids.shape[0],
                                                   ids.shape[1] + NEW)
    np.testing.assert_array_equal(got, jax_tokens[kind, shape, entry])


def test_generate_matches_no_cache_argmax(pairs):
    """As the JAX package's test: greedy generate equals recomputing the
    whole sequence with the forward at every step."""
    pm = pairs["native"][1]
    ids = _ids(1, 5)
    out = gen.generate(pm, torch.as_tensor(ids), max_new_tokens=4)
    cur = torch.as_tensor(ids).long()
    with torch.inference_mode():
        for _ in range(4):
            nxt = torch.argmax(pm(cur)[0, -1])
            cur = torch.cat([cur, nxt.view(1, 1)], dim=1)
    np.testing.assert_array_equal(out.numpy(), cur.numpy())


@pytest.mark.parametrize("entry", ["generate", "generate_scan"])
def test_eos_and_pad_match_jax(pairs, entry):
    """Row 0 stops at its first token (the others go on, padding after
    their EOS); a single row stopping at its second token ends
    ``generate`` early, the rest pad."""
    jm, pm = pairs["native"]
    ids = _ids(2, 8)
    first = np.asarray(jgen.generate(
        jm, ids, jgen.GenerationConfig(max_new_tokens=2)))[:, 8:]
    for rows, eos in ((ids, int(first[0, 0])), (ids[:1], int(first[0, 1]))):
        kw = dict(max_new_tokens=NEW, eos_token_id=eos, pad_token_id=-1)
        want = _drive(jgen, entry, jm, rows, jgen.GenerationConfig(**kw))
        got = _drive(gen, entry, pm, rows, gen.GenerationConfig(**kw))
        np.testing.assert_array_equal(got, want)
        assert (got[0, 8:] == eos).any() and got[0, -1] == -1


def _jax_mask(logits, cfg):
    import jax.numpy as jnp
    b = logits.shape[0]
    return np.asarray(jgen._mask_logits_rowwise(
        jnp.asarray(logits), jnp.full((b,), cfg.temperature, jnp.float32),
        jnp.full((b,), cfg.top_k, jnp.int32),
        jnp.full((b,), cfg.top_p, jnp.float32)))


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.8, top_k=5, top_p=0.9),
    dict(temperature=1.3, top_k=0, top_p=0.5),
    dict(temperature=0.7, top_k=12, top_p=1.0),
    dict(temperature=1.0, top_k=1, top_p=0.95),
    dict(temperature=0.0, top_k=0, top_p=1.0)])
def test_scalar_mask_keeps_jax_rowwise_set(knobs):
    """The one-shot sampler's mask (its scalar knobs broadcast to every
    row) keeps exactly the tokens JAX's row-wise mask keeps with the
    same knobs, on logits with ties at the k-th value (rounded to a
    coarse grid), and the kept logits agree."""
    rs = np.random.RandomState(4)
    logits = np.round(rs.randn(6, 64) * 2, 0).astype(np.float32)
    cfg = gen.GenerationConfig(do_sample=True, **knobs)
    got = gen.mask_logits_rowwise(torch.as_tensor(logits),
                                  *gen._knobs(cfg, 6, "cpu")[:3]).numpy()
    want = _jax_mask(logits, cfg)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    if knobs["top_p"] >= 1.0 and knobs["top_k"] == 0:
        assert keep.all()


def test_top_k_1_samples_the_argmax_and_batched_sampler():
    rs = np.random.RandomState(5)
    logits = torch.as_tensor(rs.randn(4, 50).astype(np.float32))
    rows = torch.arange(4)
    cfg = gen.GenerationConfig(do_sample=True, top_k=1, seed=9)
    for step in range(3):
        np.testing.assert_array_equal(
            gen._sample_logits(logits, cfg, step).numpy(),
            torch.argmax(logits, -1).numpy())
    # sample_logits_batched: row i draws (seed, i, step); greedy rows argmax
    knobs = (torch.full((4,), 0.9), torch.tensor([0, 5, 5, 0]),
             torch.full((4,), 0.8), torch.tensor([True, True, False, True]))
    got = gen.sample_logits_batched(logits, *knobs, seed=2, step=7)
    want = gen.sample_logits_per_slot(logits, *knobs, 2, rows,
                                      torch.full((4,), 7))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert int(got[2]) == int(torch.argmax(logits[2]))


def test_sampled_generate_equals_scan_and_replays(pairs):
    pm = pairs["native"][1]
    ids = _ids(2, 5)
    cfg = gen.GenerationConfig(max_new_tokens=NEW, **SAMPLED)
    a = gen.generate(pm, ids, cfg).numpy()
    b = gen.generate_scan(pm, ids, cfg).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gen.generate_scan(pm, ids, cfg).numpy(), b)
    # the paged caches give the same tokens on the CPU
    np.testing.assert_array_equal(
        gen.generate_paged(pm, ids, cfg, page_size=PAGE).numpy(), b)


def test_exports_match_jax():
    import paddle_tpu.inference as jinf
    import paddle_tpu_torch.inference as inf
    assert inf.generate is gen.generate and inf.generation is gen
    assert inf.GenerationConfig is gen.GenerationConfig
    assert "generate" in jinf.__all__ and "generation" in jinf.__all__
    public = {"GenerationConfig", "generate", "generate_scan",
              "generate_paged", "sample_logits_batched",
              "sample_logits_per_slot", "decode_stop_update"}
    assert set(gen.__all__) == public
    assert all(hasattr(jgen, n) for n in public)
    assert all(callable(getattr(gen, n)) for n in public)
