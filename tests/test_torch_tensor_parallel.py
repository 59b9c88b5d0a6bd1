"""Tensor parallelism of the port on 4 gloo ranks: the Column/Row/Vocab-
parallel layers and both vocab-parallel cross entropies at tp = 2 and 4,
the head-aligned shards of the fused projections (tp = 4 with 2 KV heads
replicates each over 2 ranks) and their round trip, and one training
step of the tiny Llama at dp2 x tp2 and tp4 held to JAX's unsharded
step (losses, gradients, global norm, every parameter; 1e-4 in fp32)
with uneven ignored labels per data rank."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel.mesh import HybridMesh as JaxMesh
from paddle_tpu.parallel.mp_layers import \
    parallel_cross_entropy as jax_parallel_ce
from paddle_tpu_torch.ops.vocab_ce import fused_linear_cross_entropy
from paddle_tpu_torch.parallel.api import tp_slice
from paddle_tpu_torch.models.llama import LlamaConfig, sharding_annotations
from torch_dist_workers import run_ranks
from torch_mesh_refs import (check_step, jax_step, tiny_state,
                             uneven_batch, worker_inputs)

WORLD = 4
# key: (mesh, config keywords, optimizer). AdamW's first update is
# lr * sign(g) wherever |g| is far above its eps, which hides a wrong
# gradient scale; SGD with the clip shows it, so both run. The tied
# head runs SGD: AdamW turns the fp32 noise of its near-eps embedding
# gradients into 1e-4 parameter differences.
TRAIN = {
    "dp2tp2": ({"dp": 2, "tp": 2}, {}, "adamw"),
    "tp4": ({"tp": 4}, {}, "adamw"),
    "tp4_sgd": ({"tp": 4}, {}, "sgd"),
    "dp2tp2_naive": ({"dp": 2, "tp": 2}, {"loss_impl": "naive"}, "sgd"),
    "tp2dp2_tied": ({"dp": 2, "tp": 2}, {"tie_word_embeddings": True},
                    "sgd"),
}
TP_MESHES = {"tp2": {"dp": 2, "tp": 2}, "tp4": {"tp": 4}}


def _layer_inputs():
    rs = np.random.RandomState(3)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    labels = rs.randint(0, 32, (6,))
    labels[[1, 4]] = -100
    return {"x": f(6, 16), "w_col": f(16, 24) * 0.3, "b_col": f(24),
            "w_row": f(24, 8) * 0.3, "b_row": f(8), "dy": f(6, 8),
            "table": f(32, 16), "ids": rs.randint(0, 32, (6,)),
            "de": f(6, 16), "logits": f(6, 32) * 2.0, "labels": labels,
            "h": f(6, 16), "wv": f(16, 32) * 0.3}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX steps, then one launch of the ranks for every scenario
    (the tied model's weights under their own prefix)."""
    sd, sd_tied = tiny_state(), tiny_state(tie_word_embeddings=True)
    batch = uneven_batch()
    refs, scen = {}, []
    for key, (mesh, kw, opt) in TRAIN.items():
        tied = kw.get("tie_word_embeddings", False)
        lr = 0.1 if opt == "sgd" else 1e-3
        refs[key] = jax_step(sd_tied if tied else sd, [batch], opt=opt,
                             lr=lr, **kw)
        scen.append({"fn": "train", "key": key, "args": {
            "mesh": mesh, "cfg": kw, "sd": "sdt" if tied else "sd",
            "opt": opt, "lr": lr}})
    for name, mesh in TP_MESHES.items():
        scen.append({"fn": "tp_layers", "key": "layers_" + name,
                     "args": {"mesh": mesh}})
        scen.append({"fn": "shards", "key": "shards_" + name,
                     "args": {"mesh": mesh}})
    layer_inp = _layer_inputs()
    inputs = {**worker_inputs(sd, [batch]), **layer_inp,
              **{"sdt/" + k: v for k, v in sd_tied.items()}}
    outs = run_ranks(WORLD, scen, inputs, tmp_path_factory.mktemp("tp"))
    return refs, outs, layer_inp, sd


@pytest.mark.parametrize("key", sorted(TRAIN))
def test_llama_step_matches_jax_unsharded_step(run, key):
    refs, outs, _, _ = run
    check_step(outs, key, refs[key])


def _full_layers(inp):
    """The unsharded layers in plain PyTorch: outputs and gradients."""
    t = {k: torch.tensor(v) for k, v in inp.items()}
    x = t["x"].clone().requires_grad_(True)
    wc = t["w_col"].clone().requires_grad_(True)
    wr = t["w_row"].clone().requires_grad_(True)
    br = t["b_row"].clone().requires_grad_(True)
    y = (x @ wc + t["b_col"]) @ wr + br
    (y * t["dy"]).sum().backward()
    tab = t["table"].clone().requires_grad_(True)
    e = tab[t["ids"]]
    (e * t["de"]).sum().backward()
    return {"mlp_y": y, "mlp_dx": x.grad, "w_col_grad": wc.grad,
            "w_row_grad": wr.grad, "b_row_grad": br.grad,
            "gathered": t["x"] @ t["w_col"], "emb": e,
            "emb_grad": tab.grad}


@pytest.mark.parametrize("tp", sorted(TP_MESHES))
def test_parallel_layers_match_unsharded(run, tp):
    _, outs, inp, _ = run
    want = _full_layers(inp)
    for o in outs:
        for k, v in want.items():
            np.testing.assert_allclose(o[f"layers_{tp}/{k}"],
                                       v.detach().numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("tp", sorted(TP_MESHES))
def test_parallel_cross_entropies_match_jax_and_fused_head(run, tp):
    """parallel_cross_entropy against JAX's on a tp mesh and its
    gradient against the unsharded CE's; the fused vocab-parallel CE
    (per-shard lse_and_target and the merge) against the unsharded
    fused head: nll, dh and dW."""
    import jax
    _, outs, inp, _ = run
    n = TP_MESHES[tp]["tp"]
    hm = JaxMesh.build(tp=n, devices=jax.devices()[:n])
    with hm:
        want = np.asarray(jax_parallel_ce(jnp.asarray(inp["logits"]),
                                          jnp.asarray(inp["labels"])))
    lg = torch.tensor(inp["logits"], requires_grad=True)
    lab = torch.tensor(inp["labels"])
    torch.nn.functional.cross_entropy(lg, lab, ignore_index=-100,
                                      reduction="sum").backward()
    h = torch.tensor(inp["h"], requires_grad=True)
    w = torch.tensor(inp["wv"], requires_grad=True)
    nll = fused_linear_cross_entropy(h, w, lab, reduction="none")
    nll.sum().backward()
    for o in outs:
        np.testing.assert_allclose(o[f"layers_{tp}/pce"], want, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o[f"layers_{tp}/pce_grad"],
                                   lg.grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o[f"layers_{tp}/pfce"],
                                   nll.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(o[f"layers_{tp}/pfce_dh"],
                                   h.grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o[f"layers_{tp}/pfce_dw"],
                                   w.grad.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tp", sorted(TP_MESHES))
def test_fused_projection_shards_are_head_aligned(run, tp):
    """Rank r holds its q heads, its KV heads (at tp 4 over 2 KV heads,
    KV head r // 2) and its v heads of qkv_proj, and its slice of gate
    and of up of gate_up_proj; gathering every rank's shards gives the
    JAX layout back exactly."""
    _, outs, _, sd = run
    cfg = LlamaConfig.tiny()
    n = TP_MESHES[tp]["tp"]
    n_h, n_kv, hd, m = (cfg.num_attention_heads, cfg.num_key_value_heads,
                        cfg.head_dim, cfg.intermediate_size)
    qkv = sd["model.layers.0.self_attn.qkv_proj"]
    gu = sd["model.layers.0.mlp.gate_up_proj"]
    for rank, o in enumerate(outs):
        r = rank % n                    # tp is the innermost axis
        q = qkv[:, :n_h * hd].reshape(-1, n_h, hd)
        k = qkv[:, n_h * hd:(n_h + n_kv) * hd].reshape(-1, n_kv, hd)
        v = qkv[:, (n_h + n_kv) * hd:].reshape(-1, n_kv, hd)
        per = n_h // n
        kv = slice(r // (n // n_kv), r // (n // n_kv) + 1) if n > n_kv \
            else slice(r * n_kv // n, (r + 1) * n_kv // n)
        want = np.concatenate([q[:, r * per:(r + 1) * per].reshape(
            qkv.shape[0], -1), k[:, kv].reshape(qkv.shape[0], -1),
            v[:, kv].reshape(qkv.shape[0], -1)], axis=1)
        np.testing.assert_array_equal(
            o[f"shards_{tp}/local.model.layers.0.self_attn.qkv_proj"], want)
        mp = m // n
        np.testing.assert_array_equal(
            o[f"shards_{tp}/local.model.layers.0.mlp.gate_up_proj"],
            np.concatenate([gu[:, r * mp:(r + 1) * mp],
                            gu[:, m + r * mp:m + (r + 1) * mp]], axis=1))
        for name, full in sd.items():
            np.testing.assert_array_equal(o[f"shards_{tp}/full.{name}"],
                                          full, err_msg=name)
        # shard_optimizer_state cuts a full state as shard_layer cuts
        # the parameters
        assert bool(o[f"shards_{tp}/opt_state_like_params"])


def test_tp_slice_inverts_on_every_annotated_parameter():
    """tp_slice / tp_unslice round-trip every annotated Llama-3-8B
    layout at tp 2, 4 and 8 (8 KV heads) on small stand-ins of the same
    run structure."""
    from paddle_tpu_torch.parallel.api import tp_unslice
    cfg = LlamaConfig.tiny(num_attention_heads=8, num_key_value_heads=2,
                           hidden_size=64)
    ann = sharding_annotations(cfg)
    for name, (spec, blocks) in ann.items():
        if spec is None:
            continue
        dim = spec.index("tp")
        size = sum(u * w for u, w in blocks) if blocks else 16
        full = torch.arange(size * 3, dtype=torch.float32).reshape(
            (size, 3) if dim == 0 else (3, size))
        for tp in (2, 4, 8):
            parts = [tp_slice(full, dim, blocks, tp, r) for r in range(tp)]
            assert torch.equal(tp_unslice(parts, dim, blocks, size), full)
