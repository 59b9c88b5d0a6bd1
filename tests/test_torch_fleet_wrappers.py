"""The port's fleet optimizer wrappers, distributed passes and MoE
recipe paths (the rest of ``distributed/``), as the JAX package's
``tests/test_fleet_wrappers.py`` and ``tests/test_namespace_parity3b.py``
test them: the wrappers step and delegate, ``minimize`` needs a loss or
gradients, ZeRO-1 on 2 gloo ranks at fsdp 2 (each rank holds half of
every state tensor, the parameters stay replicated and equal a
one-process run of the same steps to 1e-6 and the JAX package's
unsharded steps to 1e-4, fp32), the passes facade, and the module
paths."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
    DygraphShardingOptimizer, HybridParallelOptimizer)
from paddle_tpu_torch.optimizer import SGD, ClipGradByGlobalNorm, Momentum
from torch_dist_workers import run_ranks
from torch_mesh_refs import (TOL, jax_step, tiny_state, uneven_batch,
                             worker_inputs)

STEPS = 3


class _Block(torch.nn.Module):
    def __init__(self, d=16):
        super().__init__()
        self.lin = torch.nn.Linear(d, d)

    def forward(self, x):
        return torch.tanh(self.lin(x))


def _block():
    torch.manual_seed(0)
    return _Block()


def _mse(m):
    return ((m(torch.ones(2, 16)) - torch.zeros(2, 16)) ** 2).mean()


class TestOptimizerWrappers:
    def test_hybrid_parallel_optimizer_steps(self):
        m = _block()
        opt = HybridParallelOptimizer(SGD(learning_rate=0.1, parameters=m))
        l0 = _mse(m).item()
        for _ in range(5):
            names = [n for n, _ in m.named_parameters()]
            grads = torch.autograd.grad(_mse(m), list(m.parameters()))
            opt.step(dict(zip(names, grads)))
        assert _mse(m).item() < l0
        # delegation: the inner optimizer's surface is reachable
        assert opt.get_lr() == 0.1
        assert opt.inner_opt._bound_params["lin.weight"] is m.lin.weight

    def test_minimize_takes_a_loss_or_requires_grads(self):
        m = _block()
        opt = HybridParallelOptimizer(SGD(learning_rate=0.1, parameters=m))
        with pytest.raises(ValueError, match="grads"):
            opt.minimize()
        l0 = _mse(m).item()
        opt.minimize(_mse(m))
        assert _mse(m).item() < l0
        with pytest.raises(TypeError, match="callable"):
            HybridParallelOptimizer(SGD(learning_rate=0.1, parameters=m,
                                        grad_clip=1.0))

    def test_sharding_optimizer_without_a_mesh_delegates(self):
        m = _block()
        opt = DygraphShardingOptimizer(Momentum(learning_rate=0.1,
                                                parameters=m))
        l0 = _mse(m).item()
        opt.minimize(_mse(m))
        assert _mse(m).item() < l0
        assert opt.reduce_gradients() is None
        assert opt.inner_opt._mesh_plan is None


@pytest.fixture(scope="module")
def zero1(tmp_path_factory):
    sd = tiny_state(seed=5)
    batch = uneven_batch(seed=6)
    outs = run_ranks(2, [{"fn": "zero1", "key": "z",
                          "args": {"mesh": {"fsdp": 2}, "steps": STEPS}}],
                     worker_inputs(sd, [batch]),
                     tmp_path_factory.mktemp("zero1"))
    return sd, batch, outs


def _one_process(sd, batch):
    """The same steps in one process, no mesh."""
    from paddle_tpu_torch.convert import state_dict_from_jax
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny()
    m = LlamaForCausalLM(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(sd, cfg, device="cpu"))
    opt = Momentum(learning_rate=0.1, momentum=0.9, parameters=m,
                   grad_clip=ClipGradByGlobalNorm(1.0))
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    for _ in range(STEPS):
        m(**b, return_logits=False).backward()
        opt.step()
        opt.clear_grad()
    return {k: p.detach().numpy() for k, p in m.named_parameters()}


def test_sharding_optimizer_shards_state(zero1):
    """ZeRO-1: the plan is on the "os" level and each rank holds one flat
    half of every state tensor (the state made before wrapping cut)."""
    sd, _, outs = zero1
    for o in outs:
        assert str(o["z/level"]) == "os" and bool(o["z/reduce_gradients"])
    names = [k[len("z/numel."):] for k in outs[0] if k.startswith(
        "z/numel.")]
    assert names
    for k in names:
        n = int(np.prod(outs[0]["z/param." + k].shape))
        parts = [int(o["z/numel." + k]) for o in outs]
        assert sum(parts) == n and max(parts) == -(-n // 2), k


def test_sharding_optimizer_params_stay_replicated(zero1):
    """After every step each rank holds the whole parameters, equal
    across ranks bit for bit, to a one-process run within 1e-6 and to
    the JAX package's unsharded Momentum steps within 1e-4."""
    sd, batch, outs = zero1
    want = _one_process(sd, batch)
    for k, w in want.items():
        a, b = outs[0]["z/param." + k], outs[1]["z/param." + k]
        np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-6, err_msg=k)
    ref = jax_step(sd, [batch] * STEPS, opt="momentum", lr=0.1)
    for k, p in ref["params"].items():
        np.testing.assert_allclose(outs[0]["z/jax." + k], p, rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert any(not np.array_equal(outs[0]["z/param." + k],
                                  sd_k) for k, sd_k in _as_port(sd).items())


def _as_port(sd):
    from paddle_tpu_torch.convert import state_dict_from_jax
    from paddle_tpu_torch.models.llama import LlamaConfig
    return {k: v.numpy() for k, v in state_dict_from_jax(
        sd, LlamaConfig.tiny(), device="cpu").items()}


def test_moe_and_recompute_paths():
    import paddle_tpu_torch.distributed as d
    import paddle_tpu_torch.incubate as inc
    from paddle_tpu_torch.parallel import moe
    assert d.models.moe.MoELayer is moe.MoELayer
    assert d.models.moe.MoELayer.__name__ == "MoELayer"
    # the reference MoE recipe import path
    assert inc.distributed.models.moe.MoELayer is d.models.moe.MoELayer
    for name in ("MoEMLP", "top_k_gating", "top_k_routing"):
        assert getattr(inc.distributed.models.moe, name) is getattr(moe,
                                                                   name)
    assert d.fleet.recompute.recompute is d.recompute
    assert d.fleet.recompute.recompute_sequential is d.recompute_sequential
    assert d.fleet.recompute.recompute_hybrid is d.recompute_hybrid


def test_distributed_passes_facade():
    from paddle_tpu_torch.distributed.passes import PassManager, new_pass
    pm = PassManager([new_pass("auto_parallel_amp"),
                      new_pass("pipeline_scheduler_1F1B")])
    ctx = pm.apply([None])
    assert ctx.attrs["applied_passes"] == ["auto_parallel_amp",
                                           "pipeline_scheduler_1F1B"]
    assert pm.names == ["auto_parallel_amp", "pipeline_scheduler_1F1B"]
    with pytest.raises(ValueError, match="unknown pass"):
        new_pass("not_a_pass")


def test_passes_know_the_jax_names():
    from paddle_tpu.distributed import passes as jax_passes
    from paddle_tpu_torch.distributed import passes
    assert passes._KNOWN == jax_passes._KNOWN
    assert passes.__all__ == jax_passes.__all__
