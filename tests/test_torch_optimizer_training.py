"""The port's optimizers in training against the JAX package's, on the
CPU: 4 ``Trainer`` steps of the tiny Llama under each of SGD, Momentum,
Adamax, Adagrad, RMSProp (centered), Adadelta, Lamb and Rprop against
``paddle_tpu.trainer.Trainer`` (losses and final parameters within
1e-4, the tolerance of ``tests/test_torch_train.py``), the JAX state
through ``convert.opt_state_from_jax`` (bit for bit) and one more step
from it, and each optimizer's state through a ``CheckpointManager``
save and resume (bit for bit, and the next step's bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import opt_state_from_jax, state_dict_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.resilience import CheckpointManager
from paddle_tpu_torch.trainer import Trainer
from torch_optimizer_cases import OPTS, SLOTS

TOL = 1e-4
CFG = LlamaConfig.tiny(loss_impl="naive")


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def sd():
    """The JAX tiny Llama's weights (naive loss head) as numpy."""
    jpt.seed(5)
    jm = JaxLlama(JaxConfig.tiny(loss_impl="naive"))
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, CFG.vocab_size, (2, 33))
        out.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    return out


def _kwargs(name):
    cls, kw, kw_decay = OPTS[name]
    return cls, {"learning_rate": 1e-3, **kw, **kw_decay}


def _port_trainer(sd, name):
    cls, kw = _kwargs(name)
    tm = LlamaForCausalLM(CFG, device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, CFG, device="cpu"))
    return Trainer(tm, getattr(topt, cls)(
        parameters=tm, grad_clip=topt.ClipGradByGlobalNorm(1.0), **kw))


def _trainer_pair(sd, name):
    cls, kw = _kwargs(name)
    ours = _port_trainer(sd, name)
    jpt.seed(5)
    jm = JaxLlama(JaxConfig.tiny(loss_impl="naive"))
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    theirs = JaxTrainer(jm, getattr(jopt, cls)(
        parameters=jm, grad_clip=jclip.ClipGradByGlobalNorm(1.0), **kw),
        donate=False)
    return ours, theirs


TRAINER_CASES = ["SGD", "Momentum", "Adamax", "Adagrad", "RMSProp-centered",
                 "Adadelta", "Lamb", "Rprop"]


def _jax_state(jtr):
    st = jtr.opt_state
    return {"step": np.asarray(st["step"]),
            "master": {k: np.asarray(v)
                       for k, v in st.get("master", {}).items()},
            "slots": {k: {sk: np.asarray(sv) for sk, sv in e.items()}
                      for k, e in st["slots"].items()}}


@pytest.mark.parametrize("name", TRAINER_CASES)
def test_trainer_steps_match_jax_trainer(sd, name):
    """4 Trainer steps of the tiny Llama (global-norm clip 1.0, decay
    where the optimizer takes one) against 4 of the JAX Trainer: every
    loss and every final parameter within 1e-4; then the JAX state
    through ``opt_state_from_jax`` equals JAX's bit for bit and carries
    the port one more step with JAX's."""
    ours, theirs = _trainer_pair(sd, name)
    batches = _batches(5, seed=len(name))
    for b in batches[:4]:
        tl = ours.train_step({k: torch.tensor(v) for k, v in b.items()})
        jl = theirs.train_step({k: jnp.asarray(v) for k, v in b.items()})
        _close(tl, jl)
    final = {k: p.detach() for k, p in ours.params.items()}
    for k, v in theirs.params.items():
        _close(final[k], v)
    # the JAX state, converted, continues a port run from JAX's weights
    state = _jax_state(theirs)
    conv = opt_state_from_jax(state, ours.params)
    assert conv["step"] == 4
    for k, e in state["slots"].items():
        for sk, v in e.items():
            assert np.array_equal(conv["slots"][k][sk].numpy(), v)
    with torch.no_grad():
        for k, p in ours.params.items():
            p.copy_(torch.tensor(np.asarray(theirs.params[k])))
    ours.optimizer._state = conv
    b = batches[4]
    _close(ours.train_step({k: torch.tensor(v) for k, v in b.items()}),
           theirs.train_step({k: jnp.asarray(v) for k, v in b.items()}))
    for k, v in theirs.params.items():
        _close(ours.params[k].detach(), v)


def _live(tr):
    return {"/".join(key): t.detach().clone()
            for key, t in tr._live_tensors()}


@pytest.mark.parametrize("name", TRAINER_CASES)
def test_checkpoint_save_and_resume_bit_for_bit(sd, name, tmp_path):
    """3 steps under a CheckpointManager, then a new trainer resumes from
    the save: parameters, masters and every slot equal bit for bit, and
    a further step of both is the same bits."""
    a = _port_trainer(sd, name)
    batches = [{k: torch.tensor(v) for k, v in b.items()}
               for b in _batches(4, seed=9)]
    mgr = CheckpointManager(str(tmp_path), save_interval_steps=3)
    a.fit(iter(batches[:3]), 3, log_every=3, checkpoint_manager=mgr)
    mgr.close()
    b = _port_trainer(sd, name)
    b.fit(iter(batches[:3]), 3, log_every=3, resume="auto",
          checkpoint_manager=CheckpointManager(str(tmp_path)))
    assert b._step == 3
    la, lb = _live(a), _live(b)
    assert la.keys() == lb.keys()
    assert any(k.startswith("slots") for k in la) == bool(SLOTS[name])
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert torch.equal(a.train_step(batches[3]), b.train_step(batches[3]))
    la, lb = _live(a), _live(b)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
