"""The port's quantized serving path (paddle_tpu_torch) against the JAX
package's on the CPU: weight quantization, the weight-only int8 product,
int8 paged decode with per-page scales, the int8 KV writes, the int8
model's logits and paged decode, and the engine over the quantized tiny
Llama. Inputs come from numpy with a fixed seed; fp32 unless stated.

Tolerances: codes and scales are equal bit for bit (the same fp32
divisions and round-half-to-even on both sides); single ops 1e-5 (the
same fp32 arithmetic in another summation order); the model's logits
1e-4 (two frameworks' matmul and reduction orders through two layers,
as tests/test_torch_llama.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference import GenerationConfig as JaxGen
from paddle_tpu.models import llama as jax_llama
from paddle_tpu.nn.quantized_linear import (
    weight_dequantize as jax_weight_dequantize,
    weight_only_linear as jax_weight_only_linear,
    weight_quantize as jax_weight_quantize)
from paddle_tpu.ops.pallas.int8_matmul import (int8_matmul_pallas,
                                               xla_weight_only)
from paddle_tpu.ops.pallas.paged_attention import (paged_decode_attention,
                                                   paged_decode_xla)
from paddle_tpu.quantization import quantize_model as jax_quantize_model
from paddle_tpu.quantization import \
    quantize_state_dict as jax_quantize_state_dict
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.models import llama as pt_llama
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           parameter_shapes)
from paddle_tpu_torch.nn.quantized_linear import (weight_dequantize,
                                                  weight_only_linear,
                                                  weight_quantize)
from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops.quant import quantized_matmul, weight_only_plain
from paddle_tpu_torch.quantization import (int8_config, quantize_model,
                                           quantize_state_dict)

TOL = 1e-5
MODEL_TOL = 1e-4
PAGE = 8
LENS = (5, 6, 7, 4, 6, 5)
NEWS = (9, 12, 6, 10, 8, 11)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def jax_quant(tiny_llama):
    """The JAX package's int8-weight, int8-KV twin of the tiny Llama."""
    return jax_quantize_model(tiny_llama, kv_dtype="int8")


@pytest.fixture(scope="module")
def port_native(tiny_llama):
    cfg = LlamaConfig.tiny()
    m = LlamaForCausalLM(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in tiny_llama.state_dict().items()}, cfg,
        device="cpu"))
    return m


@pytest.fixture(scope="module")
def port_quant(port_native):
    return quantize_model(port_native, kv_dtype="int8")


# -- weight quantization -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_quantize_matches_jax_bit_for_bit(dtype):
    rs = np.random.RandomState(0)
    w = rs.normal(0, 0.02, (96, 48)).astype(np.float32)
    w[:, 3] = 0.0                                 # a channel of zeros
    w[5, 7] = 0.5                                 # an outlier
    tw = torch.tensor(w).to(getattr(torch, dtype))
    jw = jnp.asarray(tw.float().numpy()).astype(dtype)
    q, s = weight_quantize(tw)
    jq, js = jax_weight_quantize(jw)
    assert q.dtype == torch.int8 and q.shape == (48, 96)
    assert s.dtype == torch.float32 and s.shape == (48,)
    _equal(q, jq)
    _equal(s, js)
    _equal(weight_dequantize(q, s, out_dtype="float32"),
           jax_weight_dequantize(jq, js, out_dtype="float32"))


def test_quantize_state_dict_matches_jax_and_refuses_twice(tiny_llama,
                                                           port_native,
                                                           port_quant,
                                                           jax_quant):
    got = quantize_state_dict(port_native.state_dict())
    want = jax_quantize_state_dict(tiny_llama.state_dict())
    assert list(got) == list(want)
    for name, w in want.items():
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        _equal(got[name], w)
    with pytest.raises(ValueError, match="already int8"):
        quantize_state_dict(got)
    # the twin holds exactly those tensors, in the JAX twin's names
    sd, jsd = port_quant.state_dict(), jax_quant.state_dict()
    assert set(sd) == set(jsd) == set(parameter_shapes(port_quant.cfg))
    for name, w in jsd.items():
        _equal(sd[name], w)
    assert not any(p.requires_grad for n, p in port_quant.named_parameters()
                   if p.dtype == torch.int8 or n.endswith("_scale"))


def test_state_dict_from_jax_keeps_int8(jax_quant, port_quant):
    cfg = int8_config(LlamaConfig.tiny(), kv_dtype="int8")
    sd = state_dict_from_jax(
        {k: np.asarray(v) for k, v in jax_quant.state_dict().items()}, cfg,
        device="cpu")
    ref = port_quant.state_dict()
    for name, t in sd.items():
        assert t.dtype == ref[name].dtype, name
        assert torch.equal(t, ref[name]), name
    # an int8 projection carried as float (it would be cast, not copied)
    bad = {k: np.asarray(v) for k, v in jax_quant.state_dict().items()}
    bad["lm_head"] = bad["lm_head"].astype(np.float32)
    with pytest.raises(ValueError, match=r"int8_mismatch=\['lm_head'\]"):
        state_dict_from_jax(bad, cfg, device="cpu")


@pytest.mark.parametrize("call", ["int4", "group", "llm.int8", "linear_int4"])
def test_unported_algorithms_name_the_roadmap(call):
    w = torch.zeros((64, 32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if call == "int4":
            weight_quantize(w, algo="weight_only_int4")
        elif call == "group":
            weight_quantize(w, group_size=64)
        elif call == "llm.int8":
            weight_quantize(w, algo="llm.int8")
        else:
            weight_only_linear(torch.zeros((2, 64)), torch.zeros(
                (32, 32), dtype=torch.int8), weight_scale=torch.ones(32),
                weight_dtype="int4")
    with pytest.raises(ValueError):
        weight_quantize(w, algo="int3")


# -- the weight-only product -------------------------------------------------

def _product_inputs(rs, m, k, n):
    x = rs.normal(0, 1, (m, k)).astype(np.float32)
    wq, scale = jax_weight_quantize(
        jnp.asarray(rs.normal(0, 0.02, (k, n)).astype(np.float32)))
    return x, np.asarray(wq), np.asarray(scale)


def test_weight_only_plain_matches_xla_fp32_and_bf16():
    rs = np.random.RandomState(1)
    x, wq, scale = _product_inputs(rs, 5, 96, 48)        # ragged m
    tx, twq, ts = torch.tensor(x), torch.tensor(wq), torch.tensor(scale)
    _close(weight_only_plain(tx, twq, ts), xla_weight_only(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale)))
    # bf16: both sides sum exact products in fp32 and round once; held
    # within one bf16 step (2**-7 relative) of each other
    got = weight_only_plain(tx.bfloat16(), twq, ts).float().numpy()
    want = np.asarray(xla_weight_only(jnp.asarray(x).astype(jnp.bfloat16),
                                      jnp.asarray(wq), jnp.asarray(scale)),
                      np.float32)
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)
    # through the op and the linear, with leading dims and a bias
    x3 = tx.reshape(1, 5, 96)
    _close(quantized_matmul(x3, twq, ts)[0], weight_only_plain(tx, twq, ts))
    bias = rs.normal(0, 1, (48,)).astype(np.float32)
    _close(weight_only_linear(x3, twq, torch.tensor(bias), ts),
           jax_weight_only_linear(jnp.asarray(x).reshape(1, 5, 96),
                                  jnp.asarray(wq), jnp.asarray(bias),
                                  jnp.asarray(scale)))


def test_weight_only_plain_matches_pallas_kernel():
    """At a shape that divides the TPU kernel's blocks (its own gate)."""
    rs = np.random.RandomState(2)
    x, wq, scale = _product_inputs(rs, 16, 512, 256)
    got = weight_only_plain(torch.tensor(x), torch.tensor(wq),
                            torch.tensor(scale))
    _close(got, int8_matmul_pallas(jnp.asarray(x), jnp.asarray(wq),
                                   jnp.asarray(scale), block_n=128,
                                   interpret=True))


# -- int8 paged decode -------------------------------------------------------

def _quant_pages(rs, H_kv, num_pages, page, D):
    """Int8 pools from float pages of varied magnitudes, with per-page
    absmax scales; page 2 never written (scale 0, codes 0)."""
    f = rs.normal(0, 1, (H_kv, num_pages, page, D)).astype(np.float32)
    f *= rs.uniform(0.25, 4.0, (1, num_pages, 1, 1)).astype(np.float32)
    s = np.abs(f).max(axis=(0, 2, 3)) / 127.0
    q = np.clip(np.round(f / s[None, :, None, None]), -127, 127)
    q[:, 2], s[2] = 0, 0.0
    return q.astype(np.int8), s.astype(np.float32)


def test_paged_decode_plain_with_scales_matches_jax():
    _check_paged_int8(8, 2, 32, raises=True)


# the groups of ernie45_moe (5) and qwen2_moe_a14b (7), at D = 32 and 64
@pytest.mark.parametrize("H,H_kv,D", [(10, 2, 32), (14, 2, 32), (7, 1, 64)])
def test_paged_decode_plain_with_scales_matches_jax_other_groups(H, H_kv,
                                                                 D):
    _check_paged_int8(H, H_kv, D)


def _check_paged_int8(H, H_kv, D, raises=False):
    """The port's plain int8 paged decode against the JAX package's XLA
    path and its Pallas kernel (interpret mode): lengths at the first
    token, at a page edge and across one, a page never written."""
    rs = np.random.RandomState(H if D == 32 else H + D)
    B, mp, num_pages = 3, 4, 14
    q = rs.normal(0, 1, (B, H, D)).astype(np.float32)
    kp, ks = _quant_pages(rs, H_kv, num_pages, PAGE, D)
    vp, vs = _quant_pages(rs, H_kv, num_pages, PAGE, D)
    tables = rs.permutation(num_pages)[:B * mp].reshape(B, mp)
    tables[2, 1] = 2                               # reads the zero page
    lens = np.array([0, PAGE, 2 * PAGE + 3], np.int64)
    for b in range(B):
        tables[b, lens[b] // PAGE + 1:] = -1
    tables = tables.astype(np.int32)
    got = attn_ops.paged_decode_attention(
        *(torch.tensor(a) for a in (q, kp, vp, tables, lens)),
        k_scales=torch.tensor(ks), v_scales=torch.tensor(vs))
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens.astype(np.int32)))
    scales = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    _close(got, paged_decode_xla(*args, **scales))
    _close(got, paged_decode_attention(*args, **scales, interpret=True))
    if not raises:
        return
    with pytest.raises(ValueError, match="together"):
        attn_ops.paged_decode_attention(
            *(torch.tensor(a) for a in (q, kp, vp, tables, lens)),
            k_scales=torch.tensor(ks))


# -- int8 KV writes ----------------------------------------------------------

def _pools(rs, H_kv=2, num_pages=6, D=16):
    kp, ks = _quant_pages(rs, H_kv, num_pages, PAGE, D)
    vp, vs = _quant_pages(rs, H_kv, num_pages, PAGE, D)
    return kp, vp, ks, vs


def _check_pools(port, jax_pools, scale_rtol=0.0):
    """Codes equal; scales equal, or within ``scale_rtol`` where the two
    sides quantized K/V that two frameworks computed (their fp32 values,
    and so a page's absmax, may differ in the last bit)."""
    for t, j in zip(port, jax_pools):
        assert t.dtype == (torch.int8 if t.dim() == 4 else torch.float32)
        if t.dim() == 4 or not scale_rtol:
            _equal(t, j)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=scale_rtol, atol=0.0)


def test_kv_scatter_pages_matches_jax():
    rs = np.random.RandomState(3)
    pools = _pools(rs)
    phys = np.array([4, 1, 2])                     # 2 was the zero page
    k = rs.normal(0, 3, (2, 3, PAGE, 16)).astype(np.float32)
    v = rs.normal(0, 3, (2, 3, PAGE, 16)).astype(np.float32)
    got = pt_llama._kv_scatter_pages(
        tuple(torch.tensor(a) for a in pools), torch.tensor(phys),
        torch.tensor(k), torch.tensor(v))
    want = jax_llama._kv_scatter_pages(
        tuple(jnp.asarray(a) for a in pools), jnp.asarray(phys),
        jnp.asarray(k), jnp.asarray(v))
    _check_pools(got, want)


def test_kv_scatter_tokens_matches_jax():
    """A token that needs a larger scale requantizes its page; one that
    fits leaves the page's codes as they were; the zero page takes its
    first token; three idle rows land on the garbage page 0 (two at one
    offset with the same values, as idle slots at one position write)."""
    rs = np.random.RandomState(4)
    pools = _pools(rs)
    phys = np.array([3, 5, 2, 0, 0, 0])
    off = np.array([1, 6, 0, 2, 5, 2])
    k = rs.normal(0, 1, (2, 6, 16)).astype(np.float32)
    v = rs.normal(0, 1, (2, 6, 16)).astype(np.float32)
    k[:, 0] *= 50.0                                # outgrows page 3
    k[:, 1] *= 1e-3                                # fits page 5 as it is
    k[:, 5], v[:, 5] = k[:, 3], v[:, 3]            # same slot, same values
    got = pt_llama._kv_scatter_tokens(
        tuple(torch.tensor(a) for a in pools), torch.tensor(phys),
        torch.tensor(off), torch.tensor(k), torch.tensor(v))
    want = jax_llama._kv_scatter_tokens(
        tuple(jnp.asarray(a) for a in pools), jnp.asarray(phys),
        jnp.asarray(off), jnp.asarray(k), jnp.asarray(v))
    _check_pools(got, want)
    assert float(got[2][3]) > float(pools[2][3])   # page 3's scale grew
    _equal(got[0][:, 5, :6], pools[0][:, 5, :6])   # page 5 kept its codes


# -- the int8 model ----------------------------------------------------------

def test_int8_forward_logits_match_jax(port_quant, jax_quant):
    ids = np.random.RandomState(5).randint(0, 512, (2, 13))
    with torch.inference_mode():
        got = port_quant(torch.tensor(ids))
    _close(got, jax.jit(jax_quant)(jnp.asarray(ids)), MODEL_TOL)


def test_int8_model_refuses_labels(port_quant):
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="serving-only"):
        port_quant(ids, labels=ids)


def test_teacher_forced_paged_decode_matches_jax(port_quant, jax_quant):
    """Prefill a prompt that crosses a page, then feed a fixed token
    history one decode step at a time into both int8 models: per-step
    logits within MODEL_TOL, and the int8 pools' codes equal at the end
    (no code sits at a rounding tie on this seed) and their scales within
    1e-6: each is a page's absmax of K/V that the two frameworks computed
    through the layers in other summation orders, a few fp32 steps
    apart."""
    rs = np.random.RandomState(6)
    full = rs.randint(0, 512, (15,))
    L = 11
    jpools, jtables = jax_quant.model.alloc_paged_caches(1, 32, PAGE)
    tpools, ttables = port_quant.model.alloc_paged_caches(1, 32, PAGE)
    assert all(len(p) == 4 and p[0].dtype == torch.int8 for p in tpools)
    # the JAX side jitted: one compile each instead of many eager ones
    jcore = jax_quant.model
    prefill = jax.jit(lambda ids, p: jcore.prefill_paged(ids, p, jtables))
    step = jax.jit(lambda tok, pos, p: jcore.decode_step_paged(
        tok, pos, p, jtables))
    head = jax.jit(jax_quant.logits)
    jh, jpools = prefill(jnp.asarray(full[None, :L]), jpools)
    with torch.inference_mode():
        th, tpools = port_quant.model.prefill_paged(
            torch.tensor(full[None, :L]), tpools, ttables)
        _close(port_quant.logits(th[:, -1]), head(jh[:, -1]), MODEL_TOL)
        for i in range(L, len(full) - 1):
            jh, jpools = step(jnp.asarray(full[i:i + 1]),
                              jnp.asarray([i], jnp.int32), jpools)
            th, tpools = port_quant.model.decode_step_paged(
                torch.tensor(full[i:i + 1]), torch.tensor([i]), tpools,
                ttables)
            _close(port_quant.logits(th[:, 0]), head(jh[:, 0]), MODEL_TOL)
    for tp, jp in zip(tpools, jpools):
        _check_pools(tp, jp, scale_rtol=1e-6)


# -- the engine --------------------------------------------------------------

def _prompts():
    rs = np.random.RandomState(0)
    return [rs.randint(0, 512, (n,)).astype(np.int32) for n in LENS]


@pytest.fixture(scope="module")
def jax_quant_tokens(jax_quant):
    """The JAX engine's greedy tokens over the int8 twin, computed once
    (the JAX engine is exact across block size and depth)."""
    eng = JaxEngine(jax_quant, max_batch=2, page_size=PAGE, max_len=64,
                    generation_config=JaxGen(max_new_tokens=16),
                    decode_block=4)
    rids = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), NEWS)]
    out = eng.run()
    assert eng.kv_quant and eng.kv_quant_ticks > 0
    return [out[r] for r in rids]


@pytest.mark.parametrize("decode_block,async_depth",
                         [(1, 1), (1, 2), (4, 1), (4, 2)])
def test_quant_engine_greedy_tokens_equal_jax_engine(port_quant,
                                                     jax_quant_tokens,
                                                     decode_block,
                                                     async_depth):
    eng = ContinuousBatchingEngine(
        port_quant, max_batch=2, page_size=PAGE, max_len=64,
        generation_config=GenerationConfig(max_new_tokens=16),
        decode_block=decode_block, async_depth=async_depth)
    rids = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(_prompts(), NEWS)]
    out = eng.run()
    assert eng.kv_quant and eng.kv_quant_ticks == eng.decode_blocks > 0
    for r, want in zip(rids, jax_quant_tokens):
        _equal(out[r], want)
    assert eng.stats()["free_pages"] == 2 * (64 // PAGE)


def test_native_engine_is_not_kv_quant(port_native):
    eng = ContinuousBatchingEngine(port_native, max_batch=1, page_size=PAGE,
                                   max_len=16, decode_block=2)
    eng.submit(np.arange(3), max_new_tokens=3)
    eng.run()
    assert not eng.kv_quant and eng.kv_quant_ticks == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only: the ops route CPU
    tensors to the plain versions before reaching them."""
    from paddle_tpu_torch.ops.kernels import int8_matmul, paged_attention
    wq = torch.zeros((32, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul.int8_matmul(torch.zeros((2, 32)), wq, torch.ones(32))
    pool = torch.zeros((1, 2, 8, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_decode(
            torch.zeros((1, 1, 64)), pool, pool,
            torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int64),
            k_scales=torch.ones(2), v_scales=torch.ones(2))


def test_config_checks_and_int8_layout():
    """The JAX checks on the two quantization fields, the int8 layout of
    ``parameter_shapes``, and a tied model keeping its float table as
    the vocabulary head."""
    for kw in ({"weight_dtype": "int4"}, {"kv_dtype": "fp8"}):
        with pytest.raises(ValueError):
            LlamaConfig.tiny(**kw)
    shapes = parameter_shapes(int8_config(LlamaConfig.tiny()))
    assert shapes["lm_head"] == ((512, 128), "int8")
    assert shapes["lm_head_scale"] == ((512,), "scale")
    assert shapes["model.embed_tokens"] == ((512, 128), "float")
    tied = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=True),
                            device="cpu")
    q = quantize_model(tied)
    assert q.lm_head is None and "lm_head_scale" not in q.state_dict()
    assert q.cfg.kv_dtype == "native"
    ids = torch.tensor([[1, 2, 3]])
    with torch.inference_mode():
        _close(q(ids), tied(ids), 5e-2)      # quantization error only


@pytest.mark.parametrize("preset", ["llama3_8b", "tiny"])
def test_int8_product_route_follows_m_and_dtype(preset):
    """The int8 product's kernel route is a function of m and x's type
    alone, chosen before the launch: at the preset's quantized
    projections (every width a multiple of 16, as the kernel takes),
    prompt rows (m > 16: the serving run's 128 .. 1536 tokens and a
    ragged 17) take the wgmma route, a decode batch (m <= 16) the decode
    tiling and fp32 x the FMA route; each route has its launch counter
    beside the kernel's."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
    cfg = int8_config(getattr(LlamaConfig, preset)())
    projs = [shape for shape, kind in parameter_shapes(cfg).values()
             if kind == "int8"]
    assert projs and all(n % 16 == 0 and k % 16 == 0 for n, k in projs)
    for m in (17, 128, 1000, 1536):
        assert kmm.route(m, torch.bfloat16) == "wgmma"
    for m in (1, 8, 16):
        assert kmm.route(m, torch.bfloat16) == "decode"
    for m in (1, 17, 1536):
        assert kmm.route(m, torch.float32) == "fp32"
    assert set(kmm.ROUTES) == {"wgmma", "decode", "fp32"}
    for way in kmm.ROUTES:
        assert f"int8_matmul_{way}" in _build.LAUNCHES
