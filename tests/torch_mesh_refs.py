"""The JAX references of the multi-rank tests: the JAX tiny Llama, a
global batch whose data ranks hold different numbers of ignored labels,
and one unsharded JAX training step (loss, gradients, global gradient
norm, parameters after the step). GSPMD's contract is that a sharded
program computes the unsharded program's numbers; the port's sharded
step is held to them."""

import jax
import jax.numpy as jnp
import numpy as np

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.moe_lm import MoEConfig as JaxMoEConfig
from paddle_tpu.models.moe_lm import MoEForCausalLM as JaxMoE
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import Momentum as JaxMomentum
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.trainer import Trainer as JaxTrainer

TOL = 1e-4


def _family(family):
    """(model class, config class) of "llama" or "moe" (the MoE LM)."""
    return ((JaxMoE, JaxMoEConfig) if family == "moe"
            else (JaxLlama, JaxConfig))


def tiny_state(seed=5, family="llama", **cfg_kw):
    """The JAX tiny Llama's (or MoE LM's) weights (numpy) for
    ``LlamaConfig.tiny(**cfg_kw)`` (``MoEConfig.tiny``)."""
    model_cls, cfg_cls = _family(family)
    pt.seed(seed)
    jm = model_cls(cfg_cls.tiny(**cfg_kw))
    return {k: np.asarray(v) for k, v in jm.state_dict().items()}


def uneven_batch(seed=0, b=4, s=32, vocab=512):
    """Token ids and next-token labels [b, s]; each row ignores a
    different number of labels (rows 0-1 and 2-3 are the two halves of
    a dp = 2 split), so the ranks' counts differ."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s + 1))
    labels = ids[:, 1:].copy()
    labels[0, :7] = -100
    labels[1, 20:23] = -100
    labels[3, 5:6] = -100
    return {"input_ids": ids[:, :-1], "labels": labels}


def jax_step(sd, batches, opt="adamw", lr=1e-3, clip=1.0, family="llama",
             **cfg_kw):
    """The unsharded JAX step on ``batches[0]`` (loss, gradients and their
    global norm), then a JAX Trainer step on each batch in turn: the
    losses and the final parameters. ``opt``: "adamw", "sgd" or
    "momentum" (0.9). ``family`` "moe": the MoE LM."""
    model_cls, cfg_cls = _family(family)
    jm = model_cls(cfg_cls.tiny(**cfg_kw))
    jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    params = dict(jm.raw_parameters())
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_of(p):
        if family == "moe":
            return jm.functional_call(p, **jb)[0]
        return jm.functional_call(p, return_logits=False, **jb)
    vg = jax.value_and_grad(loss_of)
    # the MoE LM's eager autodiff takes tens of seconds: compile it
    loss, grads = (jax.jit(vg) if family == "moe" else vg)(params)
    gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                               for g in grads.values())))
    c = jclip.ClipGradByGlobalNorm(clip)
    if opt == "sgd":
        o = JaxSGD(learning_rate=lr, parameters=jm, grad_clip=c)
    elif opt == "momentum":
        o = JaxMomentum(learning_rate=lr, momentum=0.9, parameters=jm,
                        grad_clip=c)
    else:
        o = JaxAdamW(learning_rate=lr, parameters=jm, weight_decay=0.01,
                     grad_clip=c)
    tr = JaxTrainer(jm, o, donate=False)
    losses = [float(tr.train_step({k: jnp.asarray(v) for k, v in
                                   b.items()})) for b in batches]
    return {"loss0": float(loss), "gnorm": gnorm,
            "grads": {k: np.asarray(v) for k, v in grads.items()},
            "losses": losses,
            "params": {k: np.asarray(v) for k, v in tr.params.items()}}


def worker_inputs(sd, batches):
    out = {"sd/" + k: v for k, v in sd.items()}
    out.update({"batch/" + k: v for k, v in batches[0].items()})
    for i, b in enumerate(batches):
        out.update({f"batch{i}/" + k: v for k, v in b.items()})
    return out


def check_step(outs, key, ref, grads=True, tol=TOL):
    """Every rank's losses, and rank 0's gradients, norm and gathered
    parameters, against the JAX step within ``tol``."""
    for o in outs:
        np.testing.assert_allclose(o[f"{key}/losses"], ref["losses"],
                                   rtol=tol, atol=tol)
    o = outs[0]
    if grads:
        np.testing.assert_allclose(o[f"{key}/loss0"], ref["loss0"],
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(o[f"{key}/gnorm"], ref["gnorm"],
                                   rtol=tol, atol=tol)
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(o[f"{key}/grad.{name}"], g,
                                       rtol=tol, atol=tol, err_msg=name)
    for name, p in ref["params"].items():
        np.testing.assert_allclose(o[f"{key}/param.{name}"], p, rtol=tol,
                                   atol=tol, err_msg=name)
