"""The port's serving-engine features on the CPU against the JAX package:
the paged entry points ``prefill_chunk_paged`` / ``decode_verify_paged``
(native and int8 pools), the n-gram draft provider, and the engine's
chunked prefill, radix prefix cache (copy on write included) and
speculative decoding over the tiny Llama (weights carried from the JAX
model) and its int8 twin, plus the JAX package's safety tests of those
features, run against the port.

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
from paddle_tpu.quantization import quantize_model as jax_quantize_model
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        DraftProvider, GenerationConfig,
                                        NgramDraftProvider)
from paddle_tpu_torch.models import llama as pt_llama
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.quantization import quantize_model

TOL = 1e-5
PAGE = 8
NEW = 9
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
    cfg = LlamaConfig.tiny()
    port = LlamaForCausalLM(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in tiny_llama.state_dict().items()}, cfg,
        device="cpu"))
    return {"native": (tiny_llama, port),
            "int8": (jax_quantize_model(tiny_llama, kv_dtype="int8"),
                     quantize_model(port, kv_dtype="int8"))}


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

def _family(seed=31):
    """Five prompts sharing a 19-token prefix (two whole pages and three
    tokens) and one cold prompt."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 512, (2 * PAGE + 3,))
    fam = [np.concatenate([shared, rs.randint(0, 512, (t,))])
           for t in (3, 5, 2, 7, 12)]
    return fam + [rs.randint(0, 512, (11,))]


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
    return out, eng


def _jax_engine(model, **feats):
    return JaxEngine(model, max_batch=3, page_size=PAGE, max_len=64,
                     generation_config=JaxGen(max_new_tokens=NEW), **feats)


def _port_engine(model, **feats):
    return ContinuousBatchingEngine(
        model, max_batch=3, page_size=PAGE, max_len=64,
        generation_config=GenerationConfig(max_new_tokens=NEW), **feats)


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


# -- the JAX package's safety tests, against the port -----------------------

def _greedy(model, prompts, n):
    """Per-request greedy decoding: one slot, one step a block, no
    pipelining, no feature."""
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=PAGE,
                                   max_len=128, decode_block=1,
                                   async_depth=1)
    rids = [eng.submit(p, max_new_tokens=n) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def test_refcount_invariant_fuzz(models):
    """Random admit / evict / divergence schedules over a tight pool with
    a shared-prefix family: the page-ownership invariant holds at every
    tick, outputs are exact and the engine drains clean."""
    pm = models["native"][1]
    for seed in (0, 1, 2):
        rs = np.random.RandomState(100 + seed)
        shared = rs.randint(0, 512, (2 * PAGE,))
        eng = ContinuousBatchingEngine(
            pm, max_batch=3, page_size=PAGE, max_len=8 * PAGE, num_pages=9,
            generation_config=GenerationConfig(max_new_tokens=PAGE + 3),
            chunked_prefill=bool(seed % 2), prefix_cache=True)
        expected, outputs = {}, {}
        pending = 7
        while pending or eng.has_work():
            if pending and (rs.rand() < 0.4 or not eng.has_work()):
                if rs.rand() < 0.5:
                    p = np.concatenate(
                        [shared[:PAGE * int(rs.randint(1, 3))],
                         rs.randint(0, 512, (int(rs.randint(1, PAGE)),))])
                else:
                    p = rs.randint(0, 512, (int(rs.randint(2, 3 * PAGE)),))
                expected[eng.submit(p)] = p
                pending -= 1
            else:
                for rid, tok in eng.step():
                    outputs.setdefault(rid, []).append(tok)
            eng._check_page_invariants()
        eng._check_page_invariants()
        assert eng.stats()["inflight"] == 0
        want = _greedy(pm, list(expected.values()), PAGE + 3)
        for (rid, _), w in zip(expected.items(), want):
            np.testing.assert_array_equal(np.asarray(outputs[rid]), w,
                                          err_msg=f"seed={seed} rid={rid}")


def test_mid_prefill_eviction_releases_claims_not_tree_refs(models):
    """A chunked-prefill slot evicted before activation holds
    admission-claimed private pages plus a mapped shared prefix; eviction
    frees only the private pages and takes back only its own refs."""
    pm = models["native"][1]
    rs = np.random.RandomState(21)
    shared = rs.randint(0, 512, (2 * PAGE,))
    pa = np.concatenate([shared, rs.randint(0, 512, (3,))])
    pb = np.concatenate([shared, rs.randint(0, 512, (4 * PAGE,))])
    eng = ContinuousBatchingEngine(
        pm, max_batch=2, page_size=PAGE, max_len=12 * PAGE, num_pages=8,
        generation_config=GenerationConfig(max_new_tokens=2 * PAGE),
        chunked_prefill=True, prefill_chunk=PAGE, prefix_cache=True)
    ra = eng.submit(pa)
    for _ in range(6):
        eng.step()
    rb = eng.submit(pb)
    eng.step()
    reqb = eng._requests[rb]
    assert reqb.slot >= 0 and not eng._decode_ready(reqb)
    shared_pages = {int(p) for p in eng.tables[reqb.slot, :2]}
    assert all(eng._prefix.owns(p) for p in shared_pages)
    refs_before = {p: eng._prefix._pages[p].ref for p in shared_pages}
    evicted = False
    while eng.has_work():
        eng.step()
        eng._check_page_invariants()
        if eng.preemptions > 0 and not evicted:
            evicted = True
            for p in shared_pages:
                assert eng._prefix.owns(p)
                assert eng._prefix._pages[p].ref <= refs_before[p]
            assert not shared_pages & {int(x) for x in eng._free}
    assert evicted, "pool was not tight enough to force the eviction"
    out = eng.run()
    eng._check_page_invariants()
    want = _greedy(pm, [pa, pb], 2 * PAGE)
    np.testing.assert_array_equal(out[ra], want[0])
    np.testing.assert_array_equal(out[rb], want[1])


def test_projection_saturation_does_not_orphan_commits(models):
    """The largest-stride projection saturates r0's budget while its row,
    committing fewer, still decodes: r0 stays a participant of the next
    block, so no device commit goes undrained."""
    pm = models["native"][1]
    rs = np.random.RandomState(17)
    p0, p1 = rs.randint(0, 512, (6,)), rs.randint(0, 512, (7,))
    eng = ContinuousBatchingEngine(
        pm, max_batch=2, page_size=PAGE, max_len=64,
        generation_config=GenerationConfig(max_new_tokens=4),
        async_depth=2, spec_k=2)
    r0 = eng.submit(p0, max_new_tokens=4)
    r1 = eng.submit(p1, max_new_tokens=12)
    emitted = []
    with torch.inference_mode():
        eng._admit()
        slot0 = eng._requests[r0].slot
        assert eng._dispatch_block(emitted)
        assert eng._dispatch_block(emitted)
        assert int(eng._proj_gen[slot0]) >= 4
        assert eng._dispatch_block(emitted)
    assert slot0 in {s for s, _ in eng._inflight[-1].participants}
    out = eng.run()
    want = _greedy(pm, [p0, p1], 12)
    np.testing.assert_array_equal(out[r0], want[0][:4])
    np.testing.assert_array_equal(out[r1], want[1])
    assert eng.stats()["free_pages"] == eng._total_pages


def test_eos_and_budget_inside_accepted_run(models):
    """eos inside an accepted speculative run with the next block in
    flight, and budgets that run out mid-run: exact prefixes, every page
    back, and the slot reusable."""
    pm = models["native"][1]
    rs = np.random.RandomState(3)
    prompt = np.tile(rs.randint(0, 512, (4,)), 3)
    ref = _greedy(pm, [prompt], 10)[0]
    eos = int(ref[4])
    eng = ContinuousBatchingEngine(
        pm, max_batch=1, page_size=PAGE, max_len=64,
        generation_config=GenerationConfig(max_new_tokens=10,
                                           eos_token_id=eos),
        async_depth=2, spec_k=3)
    rid = eng.submit(prompt)
    with torch.inference_mode():
        eng._admit()
        assert eng._dispatch_block([]) and eng._dispatch_block([])
    assert eng.stats()["inflight"] == 2
    out = eng.run()
    stop = int(np.where(ref == eos)[0][0])
    np.testing.assert_array_equal(out[rid], ref[:stop + 1])
    assert eng.stats()["free_pages"] == eng._total_pages
    assert not eng.tables.any()
    for new in (1, 2, 5, 7):
        eng = ContinuousBatchingEngine(pm, max_batch=1, page_size=PAGE,
                                       max_len=64, async_depth=2, spec_k=3)
        rid = eng.submit(prompt, max_new_tokens=new)
        np.testing.assert_array_equal(eng.run()[rid], ref[:new])
        assert eng.stats()["free_pages"] == eng._total_pages


def test_custom_draft_provider_wrong_drafts_are_safe(models):
    class Adversarial(DraftProvider):
        def propose(self, history, hist_len, k):
            return torch.full((history.shape[0], k),
                              history.shape[1] % 7 + 1, dtype=torch.int64)

    pm = models["native"][1]
    rs = np.random.RandomState(11)
    prompt = np.tile(rs.randint(0, 512, (3,)), 3)
    eng = ContinuousBatchingEngine(
        pm, max_batch=1, page_size=PAGE, max_len=64,
        generation_config=GenerationConfig(max_new_tokens=10), spec_k=3,
        draft_provider=Adversarial())
    rid = eng.submit(prompt)
    np.testing.assert_array_equal(eng.run()[rid],
                                  _greedy(pm, [prompt], 10)[0])


def test_cancel_and_take_finished(models):
    pm = models["native"][1]
    prompts = _family()
    eng = _port_engine(pm, prefix_cache=True)
    rids = [eng.submit(p) for p in prompts[:5]]
    assert eng.cancel(rids[4])                    # still queued
    assert not eng.cancel(rids[4]) and not eng.cancel(12345)
    for _ in range(3):
        eng.step()
    active = eng._requests[rids[0]]
    assert active.slot >= 0
    assert eng.cancel(rids[0])                    # active: drained, freed
    assert active.slot == -1 and rids[0] not in eng._requests
    eng._check_page_invariants()
    got = {}
    while eng.has_work():
        eng.step()
        got.update(eng.take_finished())
    while eng._inflight:
        eng._reconcile_one()
    got.update(eng.take_finished())
    assert sorted(got) == rids[1:4]
    assert eng.take_finished() == {}
    want = _greedy(pm, prompts[1:4], NEW)
    for r, w in zip(rids[1:4], want):
        np.testing.assert_array_equal(got[r], w)
    eng._check_page_invariants()
    assert not eng.cancel(rids[1])                # finished and taken


def test_cancel_keeps_the_other_streams_emissions(models):
    """D13: a cancel drains the in-flight blocks, and the tokens the other
    requests commit in that drain come out of the next ``step()``: each
    survivor's emissions, concatenated, are its finished stream (the
    front door streams them; on the parent a token went missing there
    and the finished stream's last token came twice)."""
    pm = models["native"][1]
    prompts = _family()
    eng = _port_engine(pm, async_depth=2, decode_block=2)
    rids = [eng.submit(p) for p in prompts[:3]]
    seen = {r: [] for r in rids}
    for _ in range(3):
        for r, t in eng.step():
            seen[r].append(t)
    buf = []
    with torch.inference_mode():             # a block left in flight
        assert eng._dispatch_block(buf)
    for r, t in buf:
        seen[r].append(t)
    assert eng._inflight
    assert eng.cancel(rids[2])
    got = {}
    while eng.has_work() or eng._inflight:
        for r, t in (eng.step() if eng.has_work() else eng._drain_all()):
            seen[r].append(t)
        got.update(eng.take_finished())
    assert sorted(got) == rids[:2]
    for r in rids[:2]:
        assert seen[r] == got[r].tolist()


def test_cancel_drain_that_finishes_every_survivor_still_emits(models):
    """D13, when the cancel's drain finishes every other request: the
    engine still has work (the carried tokens), so a caller that steps
    only while ``has_work()`` emits them in the next ``step()``, and no
    later request's step emits them for requests already retired."""
    pm = models["native"][1]
    prompts = _family()
    eng = _port_engine(pm, async_depth=2, decode_block=2)
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts[:2]]
    rids.append(eng.submit(prompts[2]))
    seen = {r: [] for r in rids}
    for _ in range(3):
        for r, t in eng.step():
            seen[r].append(t)
    buf = []
    with torch.inference_mode():             # a block left in flight
        assert eng._dispatch_block(buf)
    for r, t in buf:
        seen[r].append(t)
    assert not any(eng._requests[r].done for r in rids[:2])
    assert eng.cancel(rids[2])
    assert all(eng._requests[r].done for r in rids[:2])
    assert not eng._queue and all(s is None for s in eng._slots)
    assert eng.has_work()
    got = {}
    while eng.has_work():
        for r, t in eng.step():
            seen[r].append(t)
        got.update(eng.take_finished())
    assert sorted(got) == rids[:2]
    for r in rids[:2]:
        assert seen[r] == got[r].tolist()
    late = eng.submit(prompts[3])
    first = eng.step()
    assert all(r == late for r, _ in first)


def test_replay_prefix_resumes_the_stream(models):
    pm = models["native"][1]
    prompt = _family()[5]
    full = _greedy(pm, [prompt], NEW)[0]
    eng = _port_engine(pm)
    rid = eng.submit(prompt, max_new_tokens=NEW, replay_prefix=full[:4])
    np.testing.assert_array_equal(eng.run()[rid], full)
    with pytest.raises(ValueError, match="exhausts"):
        eng.submit(prompt, max_new_tokens=3, replay_prefix=full[:3])


def test_feature_arguments_are_checked(models):
    pm = models["native"][1]
    with pytest.raises(ValueError, match="multiple of page_size"):
        _port_engine(pm, chunked_prefill=True, prefill_chunk=PAGE + 1)

    class M:
        model = object()
    with pytest.raises(ValueError, match="decode_verify_paged"):
        ContinuousBatchingEngine(M(), spec_k=2)
    eng = _port_engine(pm)
    assert eng.prefix_stats() == {} and eng.spec_stats() == {}
    assert "prefix_hit_tokens" not in eng.stats()
