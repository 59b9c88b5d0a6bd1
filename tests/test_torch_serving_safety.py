"""The JAX package's safety tests of the serving engine's features, run
against the port: the page-ownership invariant under random admit /
evict / divergence schedules with the prefix cache
(``_check_page_invariants`` at every tick), mid-prefill eviction,
projection saturation under speculative decoding, EOS and budgets inside
an accepted run, adversarial drafts, cancel, take_finished and
replay_prefix, and the feature arguments' checks. Every output is held
to per-request greedy decoding (one slot, no feature) exactly. The
engine-vs-JAX parity of the same features is
``test_torch_serving_features.py``."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        DraftProvider, GenerationConfig)
from torch_serving_pairs import (FEATURE_NEW as NEW, FEATURE_PAGE as PAGE,
                                 feature_engine as _port_engine,
                                 feature_family as _family, model_pairs)


@pytest.fixture(scope="module")
def models(tiny_llama):
    """{"native": (jax model, port model)}: the port's tiny Llama
    carries the JAX weights."""
    return model_pairs(tiny_llama, int8=False)


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
