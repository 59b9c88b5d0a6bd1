"""The port's optimizers (SGD, Momentum, Adamax, Adagrad, RMSProp,
Adadelta, Lamb, Rprop) against the JAX package's, on the CPU.

Each optimizer's ``apply_gradients`` over 4 seeded gradient sequences on
three of the tiny Llama's parameters (embedding, projection, norm),
with and without clipping (by value: see ``_pair``) and weight decay,
in fp32 and in bf16 with fp32 masters; a bf16 or fp16 parameter without a master (D15) under
Adam and Rprop; each optimizer's slots where ``init_state`` asks.
Tolerance 1e-4 (that of ``tests/test_torch_train.py``: the same fp32
formulas, fused or reassociated differently by XLA); a bf16 parameter
within one bf16 ulp of JAX's (two fp32 values 1e-7 apart can round to
neighbouring bf16 values). The ``Trainer`` steps and the state's round
trips are in ``tests/test_torch_optimizer_training.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from torch_optimizer_cases import OPTS, SLOTS

TOL = 1e-4
CFG = LlamaConfig.tiny(loss_impl="naive")
# three of the tiny Llama's parameters, as the update sees them: the
# embedding, a projection and a norm weight (Lamb's exclusion)
SHAPES = {n: tuple(p.shape) for n, p in
          LlamaForCausalLM(CFG, device="cpu").named_parameters()
          if n in ("model.embed_tokens", "model.layers.0.self_attn.qkv_proj",
                   "model.layers.0.input_layernorm.weight")}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _pair(name, decay, clip=None, **extra):
    """The port's and the JAX package's optimizer of case ``name``, with
    ``ClipGradByValue(clip)``. The clip is elementwise, so both sides
    update from the same clipped gradients: a global-norm clip sums in
    another order on each side (factors 1e-7 apart), and where the decay
    nearly cancels a gradient, Adamax's normalised update magnifies that
    past 1e-4. The global-norm clip itself is held to JAX's in
    ``tests/test_torch_train.py`` and in the ``Trainer`` tests."""
    cls, kw, kw_decay = OPTS[name]
    kw = {"learning_rate": 1e-2, **kw, **(kw_decay if decay else {}),
          **extra}
    ours = getattr(topt, cls)(
        grad_clip=topt.ClipGradByValue(clip) if clip else None, **kw)
    theirs = getattr(jopt, cls)(
        grad_clip=jclip.ClipGradByValue(clip) if clip else None, **kw)
    return ours, theirs


def _tensors(arrays, dtype):
    """numpy fp32 → (torch, jax) of ``dtype`` (both round to nearest)."""
    tt = {k: torch.tensor(v).to(getattr(torch, dtype))
          for k, v in arrays.items()}
    jt = {k: jnp.asarray(v).astype(getattr(jnp, dtype))
          for k, v in arrays.items()}
    return tt, jt


def _ulp_close(got, want):
    """bf16 tensors one bf16 step apart at most, or within the masters'
    1e-4 near 0 (where a step is smaller than the masters' difference)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    lim = np.maximum(np.abs(w) * 2.0 ** -7, TOL)
    assert np.all(np.abs(g - w) <= lim), float(np.max(np.abs(g - w) / lim))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay_clip", [False, True],
                         ids=["plain", "clip-decay"])
@pytest.mark.parametrize("name", list(OPTS))
def test_update_matches_jax(name, decay_clip, dtype):
    """4 updates from the same parameters and gradient sequence: every
    fp32 parameter (or bf16 parameter's fp32 master) and every slot
    within 1e-4 of JAX's; bf16 parameters within one bf16 ulp and each
    the rounding of its own master."""
    rs = np.random.RandomState(sorted(OPTS).index(name))
    params = {k: rs.normal(0, 0.5, s).astype(np.float32)
              for k, s in SHAPES.items()}
    # with masters, also for Rprop (whose default is multi_precision=False)
    ours, theirs = _pair(name, decay_clip, 0.5 if decay_clip else None,
                         multi_precision=True)
    tp, jp = _tensors(params, dtype)
    state = theirs.init_state(jp)
    for _ in range(4):
        grads = {k: rs.normal(0, 1, s).astype(np.float32)
                 for k, s in SHAPES.items()}
        tg, jg = _tensors(grads, dtype)
        ours.apply_gradients(tp, tg)
        jp, state = theirs.apply_gradients(jp, jg, state)
    st = ours._state
    assert st["step"] == int(state["step"]) == 4
    for k in SHAPES:
        assert set(st["slots"][k]) == SLOTS[name.replace("-nesterov", "")]
        for sk, sv in st["slots"][k].items():
            assert sv.dtype == torch.float32
            _close(sv, state["slots"][k][sk])
        if dtype == "float32":
            _close(tp[k], jp[k])
            continue
        master = st["master"][k]
        _close(master, state["master"][k])
        assert tp[k].dtype == torch.bfloat16
        assert torch.equal(tp[k], master.to(torch.bfloat16))
        _ulp_close(tp[k], jp[k])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", ["Adam", "Rprop"])
def test_masterless_low_precision_update_matches_jax(name, dtype):
    """D15: a bf16 or fp16 parameter with multi_precision=False (Rprop's
    default) updates as JAX does — through an fp32 copy rounded back
    once — within one ulp of its type over 4 steps; no master is kept
    and the parameter keeps its dtype and storage."""
    rs = np.random.RandomState(3)
    params = {"w": rs.normal(0, 0.5, (4, 8)).astype(np.float32),
              "b": rs.normal(0, 0.5, (8,)).astype(np.float32)}
    ours = getattr(topt, name)(learning_rate=1e-2, multi_precision=False)
    theirs = getattr(jopt, name)(learning_rate=1e-2, multi_precision=False)
    tp, jp = _tensors(params, dtype)
    ptrs = {k: v.data_ptr() for k, v in tp.items()}
    state = theirs.init_state(jp)
    for _ in range(4):
        grads = {k: rs.normal(0, 1, v.shape).astype(np.float32)
                 for k, v in params.items()}
        tg, jg = _tensors(grads, dtype)
        ours.apply_gradients(tp, tg)
        jp, state = theirs.apply_gradients(jp, jg, state)
    assert ours._state["master"] == {} and "master" not in state
    bits = 2.0 ** -(7 if dtype == "bfloat16" else 10)
    for k in params:
        assert tp[k].dtype == getattr(torch, dtype)
        assert tp[k].data_ptr() == ptrs[k]
        g = tp[k].float().numpy()
        w = np.asarray(jp[k].astype(jnp.float32))
        assert np.all(np.abs(g - w) <= np.abs(w) * bits + 1e-30), k
        assert not np.array_equal(g, params[k])     # it moved


@pytest.mark.parametrize("name", sorted(SLOTS))
def test_slots_are_built_where_asked(name):
    """``init_state(kind="pinned_host")`` builds the slots on the host one
    tensor at a time: ``_init_slots`` honours its device, Adagrad's and
    Rprop's non-zero fills included."""
    ours, theirs = _pair(name, False)
    p = torch.zeros((3, 5), dtype=torch.bfloat16)
    meta = ours._init_slots(p, torch.device("meta"))
    assert set(meta) == SLOTS[name]
    assert all(v.device.type == "meta" and v.dtype == torch.float32
               for v in meta.values())
    want = theirs._init_slots(jnp.zeros((3, 5), jnp.bfloat16))
    for sk, v in ours._init_slots(p, "cpu").items():
        assert torch.equal(v, torch.tensor(np.asarray(want[sk])))
    st = ours.init_state({"p": p}, "pinned_host")
    assert set(st["master"]) == ({"p"} if ours.multi_precision else set())
    assert set(st["slots"]["p"]) == SLOTS[name]
