"""The port's compat surface, distributed io and utils
(``paddle_tpu_torch.distributed.{compat,io,utils}``) against the JAX
package's: ProcessMesh, DistAttr and placements; ``split``;
``DistModel`` over the tiny Llama against the port's Trainer (bit for
bit) and against JAX's DistModel (1e-4); the object collectives, point
to point and ``spawn`` on 2 gloo ranks; save/load of persistables; and
``global_scatter`` / ``global_gather``."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import compat as jc
from paddle_tpu.distributed import utils as jutils
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import causal_lm_loss as jax_causal_lm_loss
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.distributed import compat, io, utils
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           causal_lm_loss)
from paddle_tpu_torch.optimizer import SGD, ClipGradByGlobalNorm
from paddle_tpu_torch.trainer import Trainer
from torch_dist_workers import compat_rank
from torch_mesh_refs import TOL, tiny_state, uneven_batch


def _kinds(placements):
    return [("S", p.dim) if type(p).__name__ == "Shard" else
            (type(p).__name__,) for p in placements]


@pytest.mark.parametrize("shape,names,specs", [
    ((2, 4), ["dp", "tp"], ["tp", None]),
    ((8,), ["fsdp"], [None, "fsdp", None]),
    ((2, 2, 2), ["pp", "dp", "tp"], ["dp", "tp"]),
])
def test_process_mesh_and_dist_attr_match_jax(shape, names, specs):
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    pm, jm = compat.ProcessMesh(ids, names), jc.ProcessMesh(ids, names)
    assert (pm.shape, pm.process_ids, pm.dim_names, pm.ndim) == \
        (jm.shape, jm.process_ids, jm.dim_names, jm.ndim)
    assert repr(pm) == repr(jm)
    assert pm == compat.ProcessMesh(ids, names)
    assert compat.ProcessMesh(ids[::-1].copy(), names) != pm
    da, jda = compat.DistAttr(pm, specs), jc.DistAttr(jm, specs)
    assert _kinds(da.placements()) == _kinds(jda.placements())
    assert da.sharding_specs == jda.sharding_specs
    assert compat.ReduceType.kRedSum == jc.ReduceType.kRedSum
    assert compat.ParallelMode.SHARDING_PARALLEL == \
        jc.ParallelMode.SHARDING_PARALLEL


def test_process_mesh_refuses_reordered_processes():
    with pytest.raises(ValueError, match="in order"):
        compat.ProcessMesh([[1, 0]], ["dp", "tp"]).hybrid_mesh()


def test_strategy_matches_jax():
    cfg = {"sharding": {"enable": True, "stage": 2},
           "pipeline": {"accumulate_steps": 4}, "custom": 3}
    st, jst = compat.Strategy(cfg), jc.Strategy(cfg)
    for k in ("sharding", "amp", "recompute", "pipeline", "fused_passes",
              "gradient_merge"):
        assert vars(getattr(st, k)) == vars(getattr(jst, k))
    assert st.custom == jst.custom == 3
    for mod in (compat, jc):
        with pytest.raises(ValueError, match="unknown keys"):
            mod.Strategy({"amp": {"bogus": 1}})


@pytest.mark.parametrize("operation,axis", [("linear", 0), ("linear", 1),
                                            ("embedding", 0)])
def test_split_matches_jax(operation, axis):
    """Out of a mesh, split builds the plain layer: JAX's output shape,
    and the product of the layer's own weights."""
    torch.manual_seed(0)
    if operation == "embedding":
        x = torch.randint(0, 16, (3, 5))
        jx = jnp.asarray(x.numpy())
    else:
        x = torch.randn(3, 8)
        jx = jnp.asarray(x.numpy())
    size = (16, 6) if operation == "embedding" else (8, 6)
    y = compat.split(x, size, operation, axis=axis)
    jy = jc.split(jx, size, operation, axis=axis)
    assert tuple(y.shape) == tuple(jy.shape)
    assert y.dtype == torch.float32 and y.device == x.device
    with pytest.raises(ValueError, match="unknown operation"):
        compat.split(x, size, "conv")


def test_parallel_env_matches_jax(monkeypatch):
    for k, v in {"PADDLE_TRAINER_ID": "3", "PADDLE_TRAINERS_NUM": "8",
                 "PADDLE_CURRENT_ENDPOINT": "10.0.0.2:6170",
                 "PADDLE_TRAINER_ENDPOINTS": "10.0.0.1:6170,10.0.0.2:6170",
                 "PADDLE_LOCAL_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    e, je = compat.ParallelEnv(), jc.ParallelEnv()
    for k in ("rank", "world_size", "nranks", "current_endpoint",
              "trainer_endpoints"):
        assert getattr(e, k) == getattr(je, k), k
    assert e.local_rank == 1


# -- DistModel ----------------------------------------------------------------

def _port_model(sd):
    cfg = LlamaConfig.tiny()
    m = LlamaForCausalLM(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(sd, cfg, device="cpu"))
    return m


def _sgd(model):
    return SGD(learning_rate=0.1, parameters=model,
               grad_clip=ClipGradByGlobalNorm(0.5))


@pytest.fixture(scope="module")
def dist_model_runs():
    """Two steps each: the port's DistModel with the model's own loss and
    with a loss function, the port's Trainer, JAX's DistModel."""
    sd = tiny_state()
    batches = [uneven_batch(seed=i) for i in range(2)]
    tb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    out = {}
    m = _port_model(sd)
    tr = Trainer(m, _sgd(m))
    out["trainer"] = ([float(tr.train_step(b)) for b in tb],
                      {k: v.detach() for k, v in m.named_parameters()})
    for tag, loss in (("own", None), ("fn", causal_lm_loss)):
        m = _port_model(sd)
        dm = compat.to_static(m, loss=loss, optimizer=_sgd(m))
        dm.train()
        out[tag] = ([float(dm(b["input_ids"], b["labels"])) for b in tb],
                    {k: v.detach() for k, v in m.named_parameters()})
        dm.eval()
        out[tag + "_eval"] = dm(tb[0]["input_ids"], tb[0]["labels"])
    jm = JaxLlama(JaxConfig.tiny())
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    jdm = jc.to_static(jm, loss=jax_causal_lm_loss, optimizer=JaxSGD(
        learning_rate=0.1, parameters=jm,
        grad_clip=jclip.ClipGradByGlobalNorm(0.5)))
    jdm.train()
    out["jax"] = ([float(jdm(jnp.asarray(b["input_ids"]),
                             jnp.asarray(b["labels"]))) for b in batches],
                  {k: np.asarray(v) for k, v in jm.state_dict().items()})
    return out


def test_dist_model_equals_trainer_bit_for_bit(dist_model_runs):
    losses, params = dist_model_runs["trainer"]
    got_losses, got = dist_model_runs["own"]
    assert got_losses == losses
    for k, v in params.items():
        assert torch.equal(got[k], v), k


def test_dist_model_with_loss_fn_matches_jax(dist_model_runs):
    losses, params = dist_model_runs["fn"]
    jlosses, jparams = dist_model_runs["jax"]
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    cfg = LlamaConfig.tiny()
    want = state_dict_from_jax(jparams, cfg, device="cpu")
    for k, v in want.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=k)
    # eval: the loss of the updated model, no gradient
    own = dist_model_runs["own_eval"]
    loss = own[0] if isinstance(own, tuple) else own
    assert not loss.requires_grad
    assert not dist_model_runs["fn_eval"].requires_grad


# -- 2 gloo ranks under compat.spawn ------------------------------------------

def test_object_collectives_p2p_and_spawn(tmp_path):
    compat.spawn(compat_rank, args=(str(tmp_path),), nprocs=2)
    r0, r1 = (json.loads((tmp_path / f"rank{r}.json").read_text())
              for r in range(2))
    for r, o in enumerate((r0, r1)):
        assert o["initialized"] and o["backend"] == "GLOO"
        assert (o["env_rank"], o["env_world"]) == (r, 2)
        assert o["gathered"] == [{"rank": 0, "sq": 0}, {"rank": 1, "sq": 1}]
        assert o["broadcast"] == ["from1", 1]
        assert o["p2p"] == [1.0, 1.0, 1.0]
    assert r0["scattered"] == [["a"]] and r1["scattered"] == [["b"]]
    assert r0["alltoall"] == [0.0, 10.0, 11.0]
    assert r1["alltoall"] == [1.0, 2.0, 3.0, 12.0, 13.0]


def test_object_collectives_in_one_process():
    """Without a process group they are a world of one, as JAX's single
    controller."""
    got, jgot = [], []
    compat.all_gather_object(got, {"x": 1})
    jc.all_gather_object(jgot, {"x": 1})
    assert got == jgot == [{"x": 1}]
    mine = []
    compat.scatter_object_list(mine, ["only"])
    assert mine == ["only"]
    objs = [1, 2]
    compat.broadcast_object_list(objs)
    assert objs == [1, 2]
    assert not compat.is_initialized() and compat.is_available()


# -- io and utils -------------------------------------------------------------

def test_save_load_persistables_round_trip(tmp_path):
    torch.manual_seed(0)
    a, b = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    io.save_persistables(None, str(tmp_path / "ck"), a)
    assert os.listdir(tmp_path / "ck") == ["persistables.pdparams"]
    assert io.load_persistables(None, str(tmp_path / "ck"), b) is b
    for k, v in a.state_dict().items():
        assert torch.equal(b.state_dict()[k], v)
    state = io.load_persistables(None, str(tmp_path / "ck"))
    assert set(state) == {"weight", "bias"}
    io.save_persistables(dirname=str(tmp_path / "d"),
                         main_program={"w": torch.ones(2)}, filename="x.pd")
    assert torch.equal(io.load_persistables(dirname=str(tmp_path / "d"),
                                            filename="x.pd")["w"],
                       torch.ones(2))
    with pytest.raises(ValueError):
        io.save_persistables(dirname=str(tmp_path))
    assert io.is_persistable(torch.zeros(1))


class _Group:
    nranks = 2


def test_global_scatter_gather_match_jax():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    lc = gc = np.array([2, 4])
    for fn, jfn in ((utils.global_scatter, jutils.global_scatter),
                    (utils.global_gather, jutils.global_gather)):
        y = fn(torch.from_numpy(x), torch.from_numpy(lc),
               torch.from_numpy(gc))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jfn(x, lc, gc)))
        with pytest.raises(NotImplementedError, match="MoELayer"):
            fn(torch.from_numpy(x), lc, gc, group=_Group())
        with pytest.raises(NotImplementedError, match="MoELayer"):
            jfn(x, lc, gc, group=_Group())
        with pytest.raises(ValueError):
            fn(x, np.array([1, 2, 3]), gc)
