"""The port's ContinuousBatchingEngine on the CPU: greedy tokens equal the
JAX engine's for every request across decode_block x async_depth and
under forced preemption; sampled streams are the same whatever the
pipelining depth or preemption."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

PAGE = 8
LENS = (5, 6, 7, 4, 6, 5)
NEWS = (9, 12, 6, 10, 8, 11)
SAMPLED = GenerationConfig(do_sample=True, temperature=0.8, top_k=40,
                           top_p=0.95)


def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 512, (n,)).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def jax_tokens(tiny_llama):
    """The JAX engine's greedy tokens, computed once: the JAX engine is
    itself exact across block size, depth and preemption."""
    from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
    from paddle_tpu.inference import GenerationConfig as JaxGen
    eng = JaxEngine(tiny_llama, max_batch=2, page_size=PAGE, max_len=64,
                    generation_config=JaxGen(max_new_tokens=16),
                    decode_block=4)
    rids = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), NEWS)]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.fixture(scope="module")
def model(tiny_llama):
    cfg = LlamaConfig.tiny()
    m = LlamaForCausalLM(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in tiny_llama.state_dict().items()}, cfg,
        device="cpu"))
    return m


def _serve(model, decode_block, async_depth, num_pages=None, sampled=()):
    eng = ContinuousBatchingEngine(
        model, max_batch=2, page_size=PAGE, max_len=64, num_pages=num_pages,
        generation_config=GenerationConfig(max_new_tokens=16),
        decode_block=decode_block, async_depth=async_depth)
    rids = [eng.submit(p, max_new_tokens=n,
                       generation_config=SAMPLED if i in sampled else None)
            for i, (p, n) in enumerate(zip(_prompts(), NEWS))]
    out = eng.run()
    return [out[r] for r in rids], eng


@pytest.mark.parametrize("decode_block,async_depth,num_pages",
                         [(1, 1, None), (1, 2, None), (4, 1, None),
                          (4, 2, None), (4, 2, 3)])
def test_greedy_tokens_equal_jax_engine(model, jax_tokens, decode_block,
                                        async_depth, num_pages):
    toks, eng = _serve(model, decode_block, async_depth, num_pages)
    for got, want in zip(toks, jax_tokens):
        np.testing.assert_array_equal(got, want)
    st = eng.stats()
    assert st["active"] == 0 and st["queued"] == 0 and st["inflight"] == 0
    assert st["free_pages"] == (num_pages or 2 * (64 // PAGE))
    if num_pages is not None:
        assert eng.preemptions >= 1
    lat = eng.latency_stats()
    assert lat["requests"] == len(LENS) and lat["tokens"] == sum(NEWS)


def test_sampled_streams_independent_of_depth_and_preemption(model,
                                                             jax_tokens):
    sampled = (1, 3, 4)
    ref, _ = _serve(model, 4, 1, sampled=sampled)
    for depth, pages in ((2, None), (2, 3), (1, 3)):
        toks, eng = _serve(model, 4, depth, num_pages=pages,
                           sampled=sampled)
        if pages is not None:
            assert eng.preemptions >= 1
        for got, want in zip(toks, ref):
            np.testing.assert_array_equal(got, want)
    # greedy rows batched with sampled ones stay greedy; sampled rows do
    # sample
    for i, (got, want) in enumerate(zip(ref, jax_tokens)):
        if i not in sampled:
            np.testing.assert_array_equal(got, want)
    assert any(not np.array_equal(ref[i], jax_tokens[i]) for i in sampled)


def test_request_ending_at_max_len_beside_a_running_one(model):
    """A slot whose request filled max_len exactly stays idle one position
    past its last page while another request still decodes."""
    eng = ContinuousBatchingEngine(
        model, max_batch=2, page_size=PAGE, max_len=2 * PAGE,
        decode_block=4, async_depth=1)
    a = eng.submit(np.arange(PAGE), max_new_tokens=PAGE)
    b = eng.submit(np.arange(3), max_new_tokens=2 * PAGE - 3)
    out = eng.run()
    assert len(out[a]) == PAGE and len(out[b]) == 2 * PAGE - 3
    assert eng.stats()["free_pages"] == 4
    solo = ContinuousBatchingEngine(model, max_batch=1, page_size=PAGE,
                                    max_len=2 * PAGE, decode_block=4)
    rb = solo.submit(np.arange(3), max_new_tokens=2 * PAGE - 3)
    np.testing.assert_array_equal(out[b], solo.run()[rb])


def test_eos_retires_request_and_submit_validates(model, jax_tokens):
    eos = int(jax_tokens[0][3])
    eng = ContinuousBatchingEngine(
        model, max_batch=1, page_size=PAGE, max_len=64,
        generation_config=GenerationConfig(max_new_tokens=12,
                                           eos_token_id=eos),
        decode_block=4)
    rid = eng.submit(_prompts()[0])
    out = eng.run()
    stop = int(np.argmax(jax_tokens[0] == eos))
    np.testing.assert_array_equal(out[rid], jax_tokens[0][:stop + 1])
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit(np.zeros(60, np.int32), max_new_tokens=10)
    with torch.inference_mode():
        assert eng.step() == []
