"""The port's serving-engine features on the CPU against the JAX package:
the paged entry points ``prefill_chunk_paged`` / ``decode_verify_paged``
(native and int8 pools), the n-gram draft provider, and the engine's
chunked prefill, radix prefix cache (copy on write included) and
speculative decoding over the tiny Llama (weights carried from the JAX
model) and its int8 twin, and the features against the plain engine (the JAX
package's safety tests of those features, run against the port, are
``test_torch_serving_safety.py``).

Tolerances: the entry points' hidden states and native pools 1e-5 (the
same fp32 arithmetic in another summation order); int8 codes equal and
page scales within 1e-6 relative (each is a page's absmax of K/V that
two frameworks computed in other orders); tokens, draft proposals and
page bookkeeping exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference import GenerationConfig as JaxGen
from paddle_tpu.inference import NgramDraftProvider as JaxNgram
from paddle_tpu.models import llama as jax_llama
from paddle_tpu_torch.inference import GenerationConfig, NgramDraftProvider
from paddle_tpu_torch.models import llama as pt_llama
from torch_serving_pairs import (FEATURE_NEW as NEW, FEATURE_PAGE as PAGE,
                                 feature_engine as _port_engine,
                                 feature_family as _family, keep_jax_fns,
                                 model_pairs, share_jax_fns)

TOL = 1e-5
SAMPLED = GenerationConfig(do_sample=True, temperature=0.9, top_k=20)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _check_pools(port, jax_pools, skip_page0=False):
    """Native pools within TOL; int8 codes equal and scales within 1e-6
    relative. ``skip_page0`` leaves out the garbage page's contents:
    several writes land on one of its slots and which one stays is not
    defined (its int8 scale, a max over them, is still compared)."""
    for t, j in zip(port, jax_pools):
        t, j = t.numpy(), np.asarray(j)
        if t.ndim == 4 and skip_page0:
            t, j = t[:, 1:], j[:, 1:]
        if t.dtype == np.int8:
            np.testing.assert_array_equal(t, j)
        elif t.ndim == 1:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0.0)
        else:
            _close(t, j)


@pytest.fixture(scope="module")
def models(tiny_llama):
    """{"native": (jax model, port model), "int8": (...)}: the port's
    tiny Llama carries the JAX weights; the int8 twins are each
    framework's quantize_model of them."""
    return model_pairs(tiny_llama)


def _alloc(jm, pm, pages):
    jp, _ = jm.model.alloc_paged_caches(1, pages * PAGE, PAGE)
    tp, _ = pm.model.alloc_paged_caches(1, pages * PAGE, PAGE)
    return jp, tp


# -- the model's paged entry points -----------------------------------------

@pytest.mark.parametrize("kind", ["native", "int8"])
def test_prefill_chunk_paged_matches_jax(models, kind):
    """Two chunks over a non-contiguous table: 2 pages at offset 0, then 3
    pages at offset 16 of which the last lies past the table (its tile
    goes to the garbage page 0)."""
    jm, pm = models[kind]
    rs = np.random.RandomState(21)
    ids = rs.randint(0, 512, (1, 5 * PAGE))
    tables = np.array([[3, 5, 1, 6]], np.int32)
    jp, tp = _alloc(jm, pm, 8)
    chunk = jax.jit(lambda i, o, p: jm.model.prefill_chunk_paged(
        i, o, p, jnp.asarray(tables)))
    with torch.inference_mode():
        for off, C in ((0, 2 * PAGE), (2 * PAGE, 3 * PAGE)):
            jh, jp = chunk(jnp.asarray(ids[:, off:off + C]), jnp.int32(off),
                           jp)
            th, tp = pm.model.prefill_chunk_paged(
                torch.tensor(ids[:, off:off + C]), off, tp,
                torch.tensor(tables))
            _close(th, jh)
            for t, j in zip(tp, jp):
                _check_pools(t, j, skip_page0=True)


@pytest.mark.parametrize("kind", ["native", "int8"])
def test_decode_verify_paged_matches_jax(models, kind):
    """Three rows of T = 4 tokens over a prefilled history: one crossing
    a page boundary (two of its tokens share a page), one running past
    its table (writes to the garbage page), one at position 0."""
    jm, pm = models[kind]
    rs = np.random.RandomState(22)
    hist = rs.randint(0, 512, (3, 3 * PAGE))
    tables = (1 + np.arange(9, dtype=np.int32)).reshape(3, 3)
    toks = rs.randint(0, 512, (3, 4))
    pos = np.array([PAGE - 2, 3 * PAGE - 2, 0])
    jp, tp = _alloc(jm, pm, 10)
    jt = jnp.asarray(tables)
    jh, jp = jax.jit(lambda i, p: jm.model.prefill_paged(i, p, jt))(
        jnp.asarray(hist), jp)
    jh, jp = jax.jit(lambda i, q, p: jm.model.decode_verify_paged(
        i, q, p, jt))(jnp.asarray(toks), jnp.asarray(pos, jnp.int32), jp)
    with torch.inference_mode():
        tt = torch.tensor(tables)
        pm.model.prefill_paged(torch.tensor(hist), tp, tt)
        th, tp = pm.model.decode_verify_paged(torch.tensor(toks),
                                              torch.tensor(pos), tp, tt)
    _close(th, jh)
    for t, j in zip(tp, jp):
        _check_pools(t, j, skip_page0=True)


def test_kv_scatter_tokens_rows_of_tokens_match_jax():
    """The [b, T] int8 token write: a row's tokens landing in one page
    (one of them outgrowing its scale), a row across a page boundary,
    and two rows writing the garbage page."""
    rs = np.random.RandomState(23)
    kp = rs.randint(-127, 128, (2, 6, PAGE, 16)).astype(np.int8)
    vp = rs.randint(-127, 128, (2, 6, PAGE, 16)).astype(np.int8)
    ks = rs.uniform(0.01, 0.05, (6,)).astype(np.float32)
    vs = rs.uniform(0.01, 0.05, (6,)).astype(np.float32)
    phys = np.array([[2, 2, 2], [3, 3, 4], [0, 0, 0]])
    off = np.array([[1, 2, 3], [6, 7, 0], [4, 5, 6]])
    k = rs.normal(0, 1, (2, 3, 3, 16)).astype(np.float32)
    v = rs.normal(0, 1, (2, 3, 3, 16)).astype(np.float32)
    k[:, 0, 1] *= 40.0                            # outgrows page 2
    pools = (kp, vp, ks, vs)
    got = pt_llama._kv_scatter_tokens(
        tuple(torch.tensor(a) for a in pools), torch.tensor(phys),
        torch.tensor(off), torch.tensor(k), torch.tensor(v))
    want = jax_llama._kv_scatter_tokens(
        tuple(jnp.asarray(a) for a in pools), jnp.asarray(phys),
        jnp.asarray(off), jnp.asarray(k), jnp.asarray(v))
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert float(got[2][2]) > float(ks[2])
    got_n = pt_llama._kv_scatter_tokens(
        (torch.zeros(2, 6, PAGE, 16), torch.zeros(2, 6, PAGE, 16)),
        torch.tensor(phys), torch.tensor(off), torch.tensor(k),
        torch.tensor(v))
    want_n = jax_llama._kv_scatter_tokens(
        (jnp.zeros((2, 6, PAGE, 16)), jnp.zeros((2, 6, PAGE, 16))),
        jnp.asarray(phys), jnp.asarray(off), jnp.asarray(k), jnp.asarray(v))
    for t, j in zip(got_n, want_n):
        np.testing.assert_array_equal(t.numpy()[:, 1:], np.asarray(j)[:, 1:])


# -- the draft provider -----------------------------------------------------

def test_ngram_provider_matches_jax():
    hist = np.array([[5, 6, 7, 9, 5, 6, 0, 0],
                     [1, 2, 3, 4, 9, 9, 9, 0]])
    out = NgramDraftProvider(3, 1).propose(torch.tensor(hist),
                                           torch.tensor([6, 7]), 3)
    np.testing.assert_array_equal(out.numpy(), [[7, 9, 5], [9, 9, 9]])
    rs = np.random.RandomState(24)
    hist = rs.randint(0, 4, (16, 24))             # small vocabulary: repeats
    lens = rs.randint(0, 25, (16,))
    for n_max, n_min, k in ((3, 1, 4), (2, 2, 3), (4, 1, 1)):
        got = NgramDraftProvider(n_max, n_min).propose(
            torch.tensor(hist), torch.tensor(lens), k)
        want = JaxNgram(n_max, n_min).propose(
            jnp.asarray(hist, jnp.int32), jnp.asarray(lens, jnp.int32), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the engine against the JAX engine --------------------------------------

def _serve(make, model, feats, rounds=((0, 1, 2, 3, 4, 5), (0, 1, 2))):
    """Serve the family, then submit prompts 0-2 again whole (full-prompt
    hits: the copy-on-write path with the prefix cache on). Returns
    [[tokens per request] per round] and the engine."""
    prompts = _family()
    eng = make(model, **feats)
    out = []
    for rnd in rounds:
        rids = [eng.submit(prompts[i]) for i in rnd]
        got = eng.run()
        out.append([np.asarray(got[r]).tolist() for r in rids])
    if make is _jax_engine:
        keep_jax_fns([eng])
    return out, eng


def _jax_engine(model, **feats):
    """The JAX engine of the feature tests; the jit functions that close
    over the model only are shared by every engine of that model in
    this module (``torch_serving_pairs.share_jax_fns``)."""
    eng = JaxEngine(model, max_batch=3, page_size=PAGE, max_len=64,
                    generation_config=JaxGen(max_new_tokens=NEW), **feats)
    share_jax_fns([eng])
    return eng


FEATURES = {
    "chunked": dict(chunked_prefill=True, prefill_chunk=2 * PAGE),
    "prefix": dict(prefix_cache=True),
    "spec3": dict(spec_k=3),
    "all": dict(chunked_prefill=True, prefix_cache=True, spec_k=3,
                async_depth=2),
}


@pytest.mark.parametrize("kind,feat", [
    ("native", "chunked"), ("native", "prefix"), ("native", "spec3"),
    ("native", "all"), ("int8", "chunked"), ("int8", "prefix"),
    ("int8", "spec3")])
def test_engine_greedy_tokens_equal_jax_engine(models, kind, feat):
    jm, pm = models[kind]
    want, jeng = _serve(_jax_engine, jm, FEATURES[feat])
    got, eng = _serve(_port_engine, pm, FEATURES[feat])
    assert got == want
    assert eng.kv_quant == (kind == "int8")
    if eng._prefix is not None:
        eng._check_page_invariants()
        assert eng.prefix_cow_copies >= 1
        assert eng.prefix_stats() == jeng.prefix_stats()
    if eng.spec_k:
        assert eng.spec_stats() == jeng.spec_stats()
        assert eng.spec_tokens_accepted > 0
    assert eng.stats()["free_pages"] == jeng.stats()["free_pages"]


def test_features_do_not_change_tokens(models):
    """spec_k 0 and 3, chunked and prefix on and off, async depth 1 and 2,
    decode_block 4: the same tokens as the plain engine."""
    pm = models["native"][1]
    ref, _ = _serve(_port_engine, pm, {})
    for feats in (dict(spec_k=3, async_depth=1),
                  dict(prefix_cache=True, decode_block=4),
                  dict(chunked_prefill=True, prefix_cache=True,
                       async_depth=1)):
        assert _serve(_port_engine, pm, feats)[0] == ref, feats


def test_spec_on_sampled_streams_equal_spec_off(models):
    pm = models["native"][1]
    prompts = _family()

    def run(**feats):
        eng = _port_engine(pm, **feats)
        rids = [eng.submit(p, generation_config=SAMPLED if i % 2 else None)
                for i, p in enumerate(prompts)]
        out = eng.run()
        return [out[r].tolist() for r in rids]
    ref = run()
    assert run(spec_k=3) == ref
    assert run(spec_k=2, async_depth=1, prefix_cache=True) == ref
