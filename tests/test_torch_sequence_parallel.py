"""Sequence parallelism of the port on 4 gloo ranks: ring attention
(sep 2 and 4, causal or not, with and without packed segment ids) and
Ulysses (sep 2 and 4, the GQA expansion at 4) against the JAX package's
on a sep mesh (Pallas interpret mode), forward and gradients; the tiny
Llama's training step with ``sequence_parallel=True`` under the ring
and under Ulysses at dp2 x sep2 held to JAX's unsharded step; and the
flash block entries' plain versions against JAX's ``flash_fwd_block`` /
``flash_bwd_block``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.parallel.mesh import HybridMesh as JaxMesh
from paddle_tpu.parallel.ring_attention import ring_attention as jax_ring
from paddle_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.parallel.ring_attention import (check_blocks,
                                                      ring_case)
from torch_dist_workers import run_ranks
from torch_mesh_refs import (check_step, jax_step, tiny_state, uneven_batch,
                             worker_inputs)

WORLD = 4
B, S, H, HK, D = 1, 64, 4, 2, 32
ATTN = [dict(fn=fn, sep=sep, causal=causal, seg=seg)
        for fn, sep, causal, seg in
        [("ring", 2, True, False), ("ring", 2, False, True),
         ("ring", 4, True, False), ("ring", 4, True, True),
         ("ring", 4, False, False), ("ulysses", 2, True, False),
         ("ulysses", 4, True, False), ("ulysses", 4, False, False)]]
STEPS = {  # key: (config keywords, optimizer, packed batch)
    "ring": ({"sequence_parallel": True}, "sgd", False),
    "ring_adamw": ({"sequence_parallel": True}, "adamw", False),
    "ring_packed": ({"sequence_parallel": True}, "sgd", True),
    "ulysses": ({"sequence_parallel": True, "sp_mode": "ulysses"}, "sgd",
                False),
}


def _key(c):
    return (f"{c['fn']}_sep{c['sep']}_{'causal' if c['causal'] else 'full'}"
            f"{'_seg' if c['seg'] else ''}")


def _attn_inputs():
    rs = np.random.RandomState(11)
    f = lambda *s: (rs.randn(*s) * 0.5).astype(np.float32)
    # four uneven segments crossing the shard boundaries
    seg = np.repeat(np.arange(4), [10, 23, 7, 24])[None].astype(np.int32)
    return {"q": f(B, S, H, D), "k": f(B, S, HK, D), "v": f(B, S, HK, D),
            "dout": f(B, S, H, D), "seg": seg}


def _packed(batch):
    b = dict(batch)
    seg = np.zeros(b["input_ids"].shape, np.int32)
    seg[:, 13:] = 1
    seg[1, 29:] = 2
    labels = b["labels"].copy()
    labels[:, 12] = -100
    labels[1, 28] = -100
    b["labels"], b["segment_ids"] = labels, seg
    return b


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    sd = tiny_state()
    batch = uneven_batch(seed=4)
    refs, scen, inputs = {}, [], {}
    for key, (kw, opt, packed) in STEPS.items():
        b = _packed(batch) if packed else batch
        lr = 0.1 if opt == "sgd" else 1e-3
        refs[key] = jax_step(sd, [b], opt=opt, lr=lr,
                             **{k: v for k, v in kw.items()
                                if k != "sp_mode"})
        inputs.update({f"b_{key}/" + k: v for k, v in b.items()})
        scen.append({"fn": "train", "key": key, "args": {
            "mesh": {"dp": 2, "sep": 2}, "cfg": kw, "opt": opt, "lr": lr,
            "batch": f"b_{key}/"}})
    for sep in (2, 4):
        cases = [dict(c, key=_key(c)) for c in ATTN if c["sep"] == sep]
        scen.append({"fn": "sp_attention", "key": f"attn{sep}", "args": {
            "mesh": {"sep": sep, "dp": WORLD // sep}, "cases": cases}})
    inp = _attn_inputs()
    inputs.update(worker_inputs(sd, [batch]))
    inputs.update(inp)
    outs = run_ranks(WORLD, scen, inputs, tmp_path_factory.mktemp("sp"))
    return refs, outs, inp


@pytest.mark.parametrize("key", sorted(STEPS))
def test_sequence_parallel_step_matches_jax_unsharded_step(run, key):
    refs, outs, _ = run
    check_step(outs, key, refs[key])


def _jax_attention(c, inp):
    hm = JaxMesh.build(sep=c["sep"], devices=jax.devices()[:c["sep"]])
    q, k, v, dout = (jnp.asarray(inp[t]) for t in ("q", "k", "v", "dout"))
    seg = jnp.asarray(inp["seg"]) if c["seg"] else None

    def f(q, k, v):
        if c["fn"] == "ring":
            o = jax_ring(q, k, v, causal=c["causal"], segment_ids=seg)
        else:
            o = jax_ulysses(q, k, v, causal=c["causal"])
        return jnp.sum(o * dout), o
    with hm:
        (_, o), grads = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("case", ATTN, ids=_key)
def test_sp_attention_matches_jax(run, case):
    """Every rank's output block and q/k/v gradient blocks, gathered,
    against JAX's ring or Ulysses attention over the same sep mesh."""
    _, outs, inp = run
    want = _jax_attention(case, inp)
    key = f"attn{case['sep']}/{_key(case)}"
    for o in outs:
        for name, w in zip(("out", "dq", "dk", "dv"), want):
            np.testing.assert_allclose(o[f"{key}.{name}"], w, rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_ring_dispatch_and_refusals():
    """Causal n = 4: each rank runs its diagonal once and the full blocks
    of lower ranks; blocks from higher ranks are skipped (4 diagonal, 6
    full, 6 skipped a direction). Shapes JAX's flash blocks refuse are
    refused; d = 256 names the flash kernel's B.1.1."""
    cases = [ring_case(r, t, 4, True) for r in range(4) for t in range(4)]
    assert cases.count("diag") == 4 and cases.count("full") == 6
    assert cases.count("skip") == 6
    assert all(ring_case(r, t, 4, False) == "full" for r in range(4)
               for t in range(4))
    with pytest.raises(ValueError):
        check_blocks(12, 4, 2, 32)
    with pytest.raises(ValueError):
        check_blocks(16, 4, 3, 32)
    with pytest.raises(NotImplementedError, match="B.1.1"):
        check_blocks(16, 4, 2, 256)


BLOCK_CASES = [(32, False, False), (32, True, False), (64, True, True),
               (64, False, True)]


@pytest.mark.parametrize("d,causal,seg", BLOCK_CASES)
def test_flash_block_entries_match_jax(d, causal, seg):
    """flash_fwd_block / flash_bwd_block (their plain versions on the
    CPU) against JAX's in interpret mode. With segment ids, query rows
    whose segment has no key in the block come back with lse = -1e30 and
    out = 0; the backward takes a global (out, lse) of a different
    block, as the ring's does."""
    rs = np.random.RandomState(d + 2 * causal + seg)
    sq = 32
    f = lambda *s: (rs.randn(*s) * 0.5).astype(np.float32)
    q, k, v, dout = f(2, sq, H, d), f(2, sq, HK, d), f(2, sq, HK, d), \
        f(2, sq, H, d)
    qs = ks = None
    if seg:
        qs = np.repeat(np.arange(4), 8)[None].repeat(2, 0).astype(np.int32)
        ks = np.repeat(np.arange(1, 5), 8)[None].repeat(2, 0).astype(
            np.int32)                  # segment 0 has no key here
    scale = 1.0 / np.sqrt(d)
    jargs = dict(q_seg=None if qs is None else jnp.asarray(qs),
                 kv_seg=None if ks is None else jnp.asarray(ks))
    jo, jl = jfa.flash_fwd_block(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, causal, 16, 16,
                                 True, **jargs)
    t = lambda a: None if a is None else torch.tensor(a)
    to, tl = attn_ops.flash_fwd_block(t(q), t(k), t(v), scale, causal,
                                      t(qs), t(ks))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    if seg:
        assert np.all(tl.numpy()[:, :, :8] == -1e30)
        assert np.all(to.numpy()[:, :8] == 0.0)
    # a global (out, lse): this block's merged with a second block's
    o2, l2 = attn_ops.flash_fwd_block(t(q), t(f(2, sq, HK, d)),
                                      t(f(2, sq, HK, d)), scale, False)
    lse = torch.logaddexp(tl, l2)
    out = (to * torch.exp(tl - lse).transpose(1, 2)[..., None]
           + o2 * torch.exp(l2 - lse).transpose(1, 2)[..., None])
    jg = jfa.flash_bwd_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(out.numpy()),
                             jnp.asarray(lse.numpy()), jnp.asarray(dout),
                             scale, causal, 16, 16, True, **jargs)
    tg = attn_ops.flash_bwd_block(t(q), t(k), t(v), out, lse, t(dout),
                                  scale, causal, t(qs), t(ks))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
