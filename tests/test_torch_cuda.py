"""The port's CUDA kernels and serving engine on the card, held against
their plain PyTorch versions. Every test needs a CUDA device and skips
without one. The file imports neither JAX nor the JAX package, so it runs
where they are not installed, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: fp32 1e-5 (the same fp32 arithmetic in another summation
order); bf16 2e-2 (both sides compute in fp32 and round once to bf16,
whose step is 2**-8 relative, so they may land one step apart).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops import norm as norm_ops
from paddle_tpu_torch.ops import rope as rope_ops
from paddle_tpu_torch.ops.kernels import (_build, fused_norm, fused_rope,
                                          paged_attention)

pytestmark = pytest.mark.cuda
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,D", [(1, 4096), (5, 256), (3, 100)])
def test_rms_norm_kernel_matches_plain(dev, dtype, R, D):
    """Vector (D % 8 == 0) and scalar paths, fp32 and x-typed weights,
    and the fp32 rstd output."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(R * D)
    x = torch.randn((R, D), generator=g, device=dev).to(dt)
    want_rstd = torch.rsqrt(x.float().pow(2).mean(-1) + 1e-5)
    for wdt in (torch.float32, dt):
        w = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(wdt)
        y, rstd = fused_norm.rms_norm_fwd(x, w, 1e-5, return_rstd=True)
        _close(y, norm_ops._rms_norm_plain(x, w, 1e-5), dtype)
        torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_kernel_matches_plain(dev, dtype):
    """q and k as strided views of one fused qkv; contiguous positions
    (prefill) and per-row positions (decode), some past the table, which
    both sides clamp."""
    dt = getattr(torch, dtype)
    b, s, h, hk, d = 2, 5, 4, 2, 64
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((b, s, (h + 2 * hk) * d), generator=g,
                      device=dev).to(dt)
    q = qkv[..., :h * d].view(b, s, h, d)
    k = qkv[..., h * d:(h + hk) * d].view(b, s, hk, d)
    cos, sin = rope_ops.rope_freqs(d, 32, device=dev)
    pos = torch.randint(0, 40, (b, s), generator=g, device=dev)
    for p in (None, pos):
        got = fused_rope.fused_rope(q, k, cos, sin, p)
        want = rope_ops._rope_plain(q, k, cos, sin, p)
        for a, w in zip(got, want):
            _close(a, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,H_kv,D,page", [(8, 8, 64, 16), (8, 4, 128, 16),
                                           (16, 4, 128, 24),
                                           (16, 2, 256, 8)])
def test_paged_decode_kernel_matches_plain(dev, dtype, H, H_kv, D, page):
    """GQA groups 1/2/4/8, every head dim the kernel takes, pages that a
    staged chunk spans or splits, and lengths at the first token, at and
    across a page edge and at the full table; unused table slots -1."""
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(H + D + page)
    B, mp = 4, 8
    num_pages = B * mp + 1
    q = rs.normal(0, 1, (B, H, D)).astype(np.float32)
    kp = rs.normal(0, 1, (H_kv, num_pages, page, D)).astype(np.float32)
    vp = rs.normal(0, 1, (H_kv, num_pages, page, D)).astype(np.float32)
    tables = rs.permutation(num_pages)[:B * mp].reshape(B, mp)
    lens = np.array([0, page - 1, page, mp * page - 1], np.int64)
    for i in range(B):
        tables[i, lens[i] // page + 1:] = -1
    args = [torch.tensor(a, device=dev).to(dt) for a in (q, kp, vp)] + [
        torch.tensor(tables.astype(np.int32), device=dev),
        torch.tensor(lens, device=dev)]
    _close(paged_attention.paged_decode(*args),
           attn_ops.paged_decode_plain(*args), dtype)


def test_engine_on_card_matches_cpu(dev):
    """The same seeded model served on the card (kernels) and on the CPU
    (plain versions): greedy and sampled streams agree token for token,
    and every kernel launched on the card."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)          # head_dim 64
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    card = LlamaForCausalLM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (5, 13, 8, 20)]
    sampled = GenerationConfig(do_sample=True, temperature=0.8, top_k=40,
                               top_p=0.95)

    def serve(model):
        eng = ContinuousBatchingEngine(model, max_batch=2, page_size=8,
                                       max_len=64, decode_block=4,
                                       async_depth=2)
        rids = [eng.submit(p, max_new_tokens=10,
                           generation_config=sampled if i % 2 else None)
                for i, p in enumerate(prompts)]
        out = eng.run()
        return [out[r] for r in rids]
    want = serve(cpu)
    _build.reset_launches()
    got = serve(card)
    assert all(n > 0 for n in _build.LAUNCHES.values()), _build.LAUNCHES
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)
