"""Expert parallelism of the port on 4 gloo ranks.

* One MoE layer (16 wide, 4 experts of 32, top 2) with its experts split
  over ep, each rank routing its block of the tokens: the outputs,
  input gradients, aux loss and the gradients of sum(out * dout) + aux
  against JAX's OWN ep path (its shard_map'd all-to-all on a 4-device
  CPU mesh, as ``tests/test_moe_ep.py`` runs it) for dropless routing
  at ep 4 and at dp 2 x ep 2, and capacity routing at ep 4 (each rank's
  capacity from its own tokens, as in JAX, which drops other tokens
  than the unsharded layer); the split sizes read once a dropless layer;
  the same layer over virtual ranks in one process (the exchange a
  permutation) against the gloo all-to-all.
* The tiny MoE LM through ``shard_layer`` and ``Trainer`` at ep 4,
  dp 2 x ep 2 and tp 2 x ep 2 (dropless), ep 4 with capacity routing,
  and dp 2 x tp 2 without ep, held to JAX's UNSHARDED step (losses,
  synced gradients, global norm, every parameter; 1e-4 in fp32) with
  uneven ignored labels; the capacity cases at a capacity factor (2 =
  experts / top-k) at which no token is dropped on either side, since
  a rank's capacity counts its own tokens only.
* Capacity routing on a data mesh without ep (dp 4 for one layer, dp 2
  x tp 2 for the MoE LM) at the default capacity factor 1.25, where
  tokens are dropped: the port routes the global batch against the
  global capacity, so the layer (outputs, dx, aux, gradients) and the
  step equal JAX's UNSHARDED layer and step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import paddle_tpu as pt
from paddle_tpu.parallel import HybridMesh as JaxMesh
from paddle_tpu.parallel import shard_tensor
from paddle_tpu.parallel.moe import MoELayer as JaxMoELayer
from torch_dist_workers import run_ranks
from torch_mesh_refs import (check_step, jax_step, tiny_state, uneven_batch,
                             worker_inputs)

WORLD = 4
# key: (mesh degrees as HybridMesh.build takes them, capacity factor)
LAYER = {
    "ep4_dropless": ({"dp": 4, "ep": 4}, None),
    "dp2ep2_dropless": ({"dp": 4, "ep": 2}, None),
    "ep4_capacity": ({"dp": 4, "ep": 4}, 1.25),
}
# key: (mesh, capacity factor, optimizer)
TRAIN = {
    "ep4_dropless": ({"dp": 4, "ep": 4}, None, "sgd"),
    "dp2ep2_dropless": ({"dp": 4, "ep": 2}, None, "sgd"),
    "tp2ep2_dropless": ({"dp": 2, "ep": 2, "tp": 2}, None, "sgd"),
    "ep4_capacity": ({"dp": 4, "ep": 4}, 2.0, "sgd"),
    "dp2tp2_capacity": ({"dp": 2, "tp": 2}, 2.0, "sgd"),
    "dp2tp2_capacity_125": ({"dp": 2, "tp": 2}, 1.25, "sgd"),
}
# key: (mesh, capacity factor) of the layer on a data mesh without ep,
# held to JAX's unsharded layer
LAYER_DP = {"dp4_capacity": ({"dp": 4}, 1.25)}


def _skewed(x):
    """``x`` plus one seeded direction for every token: the router then
    prefers some experts, and capacity 1.25 drops tokens."""
    return x + np.random.RandomState(3).randn(x.shape[-1]).astype(
        np.float32)


def _drops(gate_logits, k, cf):
    """The (token, choice) entries the unsharded capacity routing drops."""
    import torch
    from paddle_tpu_torch.parallel.moe import top_k_routing
    t, e = gate_logits.shape
    cap = int(np.ceil(t * k / e * cf))
    slot, _, _ = top_k_routing(torch.as_tensor(gate_logits), k, cap)
    return int((slot == e * cap).sum())


def _layer(cf):
    """JAX's MoE layer from seed 0 and its weights."""
    pt.seed(0)
    moe = JaxMoELayer(hidden_size=16, ffn_size=32, num_experts=4, top_k=2,
                      capacity_factor=cf)
    return moe, {k: np.asarray(v) for k, v in moe.state_dict().items()}


def _layer_ref(mesh, cf, x, dout):
    """The value and gradients of sum(out * dout) + aux of JAX's layer
    under ``mesh`` (None: unsharded): outputs, aux, dx, gradients."""
    moe, _ = _layer(cf)
    params = dict(moe.raw_parameters())

    def f(p, xb):
        o, a = moe.functional_call(p, xb)
        return jnp.sum(o * dout) + a, (o, a)
    step = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    if mesh is None:
        (_, (o, a)), (gp, gx) = step(params, jnp.asarray(x))
    else:
        n = mesh.get("dp", 1) * mesh.get("tp", 1)
        hm = JaxMesh.build(devices=jax.devices()[:n], **mesh)
        with hm:
            xs = shard_tensor(jnp.asarray(x), spec=P(("dp", "ep"), None,
                                                     None))
            (_, (o, a)), (gp, gx) = step(params, xs)
    return {"out": np.asarray(o), "aux": float(a), "dx": np.asarray(gx),
            **{"grad." + k: np.asarray(v) for k, v in gp.items()}}


def _check_layer(o, k, ref):
    """Outputs, dx and aux within 2e-5 (the JAX ep test's tolerance),
    every gathered, synced gradient within 1e-5 of ``ref``'s."""
    np.testing.assert_allclose(o[f"{k}/out"].reshape(ref["out"].shape),
                               ref["out"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(o[f"{k}/dx"].reshape(ref["dx"].shape),
                               ref["dx"], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(o[f"{k}/aux"]), ref["aux"], rtol=1e-5)
    for name in ("gate_weight", "experts.w_gate_up", "experts.w_down"):
        np.testing.assert_allclose(o[f"{k}/grad.{name}"],
                                   ref["grad." + name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, then the ranks, with the JAX references computed while
    they run."""
    rs = np.random.RandomState(2)
    x = rs.randn(8, 4, 16).astype(np.float32)
    dout = rs.randn(8, 4, 16).astype(np.float32)
    inputs = {"moe_x": x, "moe_dout": dout, "moe_x_skew": _skewed(x)}
    inputs.update({"moe/" + k: v for k, v in _layer(None)[1].items()})
    scen = [{"fn": "moe_layer", "key": "layer_" + key,
             "args": {"mesh": mesh, "cf": cf}}
            for key, (mesh, cf) in LAYER.items()]
    scen += [{"fn": "moe_layer", "key": "layer_" + key,
              "args": {"mesh": mesh, "cf": cf, "x": "moe_x_skew"}}
             for key, (mesh, cf) in LAYER_DP.items()]
    batch = uneven_batch(seed=4)
    states = {}
    for key, (mesh, cf, opt) in TRAIN.items():
        if cf not in states:
            states[cf] = tiny_state(seed=8, family="moe", capacity_factor=cf)
            inputs.update({f"sd_{cf}/" + k: v
                           for k, v in states[cf].items()})
        scen.append({"fn": "train", "key": key, "args": {
            "mesh": mesh, "family": "moe", "cfg": {"capacity_factor": cf},
            "sd": f"sd_{cf}", "opt": opt, "lr": 0.1 if opt == "sgd"
            else 1e-3}})
    inputs.update(worker_inputs({}, [batch]))
    refs = {}

    def references():
        for key, (mesh, cf) in LAYER.items():
            refs["layer_" + key] = _layer_ref(mesh, cf, x, dout)
        # the unsharded capacity layer drops other tokens than the ep path
        refs["layer_capacity_unsharded"] = _layer_ref(None, 1.25, x, dout)
        for key, (_, cf) in LAYER_DP.items():
            refs["layer_" + key] = _layer_ref(None, cf, _skewed(x), dout)
        memo = {}
        for key, (_, cf, opt) in TRAIN.items():
            if (cf, opt) not in memo:
                memo[cf, opt] = jax_step(
                    states[cf], [batch], opt=opt,
                    lr=0.1 if opt == "sgd" else 1e-3, family="moe",
                    capacity_factor=cf)
            refs[key] = memo[cf, opt]
    outs = run_ranks(WORLD, scen, inputs, tmp_path_factory.mktemp("ep"),
                     during=references)
    return refs, outs


@pytest.mark.parametrize("key", sorted(LAYER))
def test_ep_layer_matches_jax_ep_path(run, key):
    """Outputs, dx and aux within 2e-5 (the JAX ep test's tolerance),
    every gathered, synced gradient within 1e-5 of JAX's."""
    refs, outs = run
    for o in outs:
        _check_layer(o, "layer_" + key, refs["layer_" + key])


def test_capacity_ep_counts_local_tokens(run):
    """The capacity case drops tokens: the unsharded layer (capacity from
    all 32 tokens) gives other outputs than JAX's ep path and the port's
    (capacity from each rank's 8), which agree."""
    refs, outs = run
    ep = refs["layer_ep4_capacity"]["out"]
    whole = refs["layer_capacity_unsharded"]["out"]
    assert np.abs(ep - whole).max() > 0.1 * np.abs(whole).max()
    got = outs[0]["layer_ep4_capacity/out"].reshape(ep.shape)
    np.testing.assert_allclose(got, ep, rtol=2e-5, atol=2e-5)


def test_dropless_ep_reads_split_sizes_once_and_virtual_equals_gloo(run):
    """A dropless ep layer's forward reads the split sizes once (capacity
    routing, equal splits, never); over virtual ranks in one process the
    layer gives the gloo ranks' outputs, and where the ep group holds the
    whole batch (ep 4) their aux and input gradients too."""
    _, outs = run
    for key in LAYER:
        k = "layer_" + key
        for o in outs:
            assert int(o[f"{k}/host_reads"]) == (1 if "dropless" in key
                                                 else 0)
        o = outs[0]
        ep = LAYER[key][0]["ep"]
        n = len(o[f"{k}/virtual_out"])
        np.testing.assert_allclose(o[f"{k}/virtual_out"], o[f"{k}/out"][:n],
                                   rtol=1e-6, atol=1e-6)
        if ep == WORLD:
            # the whole batch in one ep group: the same aux, hence dx
            np.testing.assert_allclose(o[f"{k}/virtual_dx"],
                                       o[f"{k}/dx"][:n], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(float(o[f"{k}/virtual_aux"]),
                                       float(o[f"{k}/aux"]), rtol=1e-6)


@pytest.mark.parametrize("key", sorted(TRAIN))
def test_moe_lm_step_matches_jax_unsharded_step(run, key):
    refs, outs = run
    check_step(outs, key, refs[key])


@pytest.mark.parametrize("key", sorted(LAYER_DP))
def test_dp_capacity_layer_matches_jax_unsharded_layer(run, key):
    """On a data mesh without ep the capacity comes from the global
    token count and every (token, choice) keeps its global priority:
    each rank's outputs, dx, aux and gradients equal JAX's unsharded
    layer, at a capacity factor where that layer drops tokens."""
    refs, outs = run
    _, w = _layer(None)
    x = _skewed(np.random.RandomState(2).randn(8, 4, 16).astype(np.float32))
    logits = x.reshape(-1, 16) @ w["gate_weight"]
    assert _drops(logits, 2, LAYER_DP[key][1]) > 0
    for o in outs:
        _check_layer(o, "layer_" + key, refs["layer_" + key])


def test_dp_capacity_step_drops_tokens():
    """The MoE LM case at capacity 1.25 is not vacuous: its unsharded
    forward drops (token, choice) entries of the global batch."""
    import torch
    from paddle_tpu_torch.convert import state_dict_from_jax
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM
    from paddle_tpu_torch.parallel.moe import MoELayer
    cf = TRAIN["dp2tp2_capacity_125"][1]
    cfg = MoEConfig.tiny(capacity_factor=cf)
    m = MoEForCausalLM(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(
        tiny_state(seed=8, family="moe", capacity_factor=cf), cfg,
        device="cpu"))
    seen = []
    for mod in m.modules():
        if isinstance(mod, MoELayer):
            mod.register_forward_hook(
                lambda mod, a, o: seen.append(mod._logits(
                    a[0].reshape(-1, a[0].shape[-1])).detach().numpy()))
    with torch.no_grad():
        m(torch.as_tensor(uneven_batch(seed=4)["input_ids"]))
    assert seen and sum(_drops(lg, cfg.num_experts_per_tok, cf)
                        for lg in seen) > 0
