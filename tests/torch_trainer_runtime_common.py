"""Shared by the port's trainer-runtime parity tests
(``tests/test_torch_trainer_runtime.py``, ``tests/test_torch_trainer_state.py``):
the JAX tiny Llama's weights, a seeded token stream both packages'
DataLoaders can index, a poisoning collate function, and the two
frameworks' trainers over the same weights and schedule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr
from paddle_tpu_torch.testing import chaos
from paddle_tpu_torch.trainer import Trainer

TOL = 1e-4
B, S = 2, 16


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def sd():
    """The JAX tiny Llama's weights (naive loss head) as numpy."""
    jpt.seed(5)
    jm = JaxLlama(JaxConfig.tiny(loss_impl="naive"))
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


CFG = LlamaConfig.tiny(loss_impl="naive")


class Tokens:
    """A seeded token stream both packages' DataLoaders can index."""

    def __init__(self, n=24):
        self.ids = np.random.RandomState(3).randint(0, CFG.vocab_size,
                                                    (n * B, S + 1))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i, :-1], "labels": self.ids[i, 1:]}


class PoisonOnce:
    """A collate function that poisons the ``at``-th batch it collates,
    once: the batch gains a NaN additive attention mask (the loss of an
    int-only batch has no float input to poison otherwise), so its loss
    is NaN. A replay after a rollback collates the batch again, clean."""

    def __init__(self, at, lib):
        self.at, self.n, self.lib = at, 0, lib

    def __call__(self, items):
        b = self.lib.default_collate_fn(items)
        self.n += 1
        if self.n - 1 != self.at:
            return b
        mask = np.zeros((B, 1, 1, S), np.float32)
        return self.lib_chaos.nan_batch({**b, "attn_mask": mask},
                                        fields=["attn_mask"])


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=10,
                                                     eta_min=1e-5),
                            warmup_steps=3, start_lr=0.0, end_lr=1e-3)


def ours(sd, donate=True, weights=True, **kw):
    m = LlamaForCausalLM(CFG, device="cpu",
                         generator=torch.Generator().manual_seed(11))
    if weights:
        m.load_state_dict(state_dict_from_jax(sd, CFG, device="cpu"))
    return Trainer(m, AdamW(learning_rate=_sched(lr), parameters=m,
                            weight_decay=0.01,
                            grad_clip=ClipGradByGlobalNorm(1.0)),
                   donate=donate, **kw)


def theirs(sd):
    jpt.seed(5)
    jm = JaxLlama(JaxConfig.tiny(loss_impl="naive"))
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    return JaxTrainer(jm, JaxAdamW(learning_rate=_sched(jlr), parameters=jm,
                                   weight_decay=0.01,
                                   grad_clip=jclip.ClipGradByGlobalNorm(1.0)),
                      donate=False)


def loader(lib, poison_at=None, **kw):
    collate = None
    if poison_at is not None:
        collate = PoisonOnce(poison_at, lib)
        collate.lib_chaos = chaos if lib is tio else jchaos
    return lib.DataLoader(Tokens(), batch_size=B, collate_fn=collate, **kw)


def params(tr):
    return {k: p.detach().clone() for k, p in tr.params.items()}


def bit_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def jax_close(tr_params, jtr):
    for k, v in jtr.params.items():
        _close(tr_params[k], v)
