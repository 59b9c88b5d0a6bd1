"""The port's training API beside the optimizers against the JAX
package's, on the CPU: ``amp`` (``auto_cast`` / ``maybe_cast_inputs``,
the attention call site, ``decorate``, ``GradScaler``, ``debugging``,
the device queries), ``regularizer`` (``L1Decay``, ``L2Decay``),
``nn.clip.clip_by_norm`` and ``incubate.optimizer`` (``LookAhead``,
``ModelAverage`` over 6 steps). Inputs come from numpy with fixed seeds.
Tolerances: 1e-6 for fp32 elementwise arithmetic (the same formula),
2e-2 for bf16 attention (both compute in fp32 and round once to bf16),
scaler counters and skip decisions exactly.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.incubate.extras import LookAhead as JLookAhead
from paddle_tpu.incubate.extras import ModelAverage as JModelAverage
from paddle_tpu.nn import clip as jnclip
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import initializer as I
from paddle_tpu_torch import amp, optimizer, regularizer
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.incubate import optimizer as tinc
from paddle_tpu_torch.nn import clip as tnclip
from paddle_tpu_torch.nn import functional as tF

# the modules (the packages' ``auto_cast`` names are the functions)
jac = importlib.import_module("paddle_tpu.amp.auto_cast")
tac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")
TOL = 1e-6


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


# -- auto_cast ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"dtype": "float16"}, {"custom_black_list": ["attention"]},
    {"custom_white_list": ["softmax"]}, {"enable": False},
    {"level": "O2", "custom_white_list": ["mean"],
     "custom_black_list": ["linear"]}],
    ids=["default", "fp16", "black-attention", "white-softmax", "off",
         "O2-lists"])
def test_auto_cast_and_maybe_cast_inputs_match_jax(kw):
    """The thread state inside and after the region, and the inputs each
    op sees (floating ones cast, others untouched), as JAX's."""
    rs = np.random.RandomState(0)
    f32 = rs.randn(3, 4).astype(np.float32)
    ints = np.arange(6, dtype=np.int32)
    ops = ("attention", "linear", "softmax", "mean", "matmul", "rms_norm")
    with jac.auto_cast(**kw), tac.auto_cast(**kw):
        js, ts = jac.amp_state(), tac.amp_state()
        assert js.enabled == ts.enabled and js.level == ts.level
        assert js.white == ts.white and js.black == ts.black
        assert str(jnp.dtype(js.dtype)) == str(ts.dtype).split(".")[-1]
        for op in ops:
            jo = jac.maybe_cast_inputs(op, jnp.asarray(f32),
                                       jnp.asarray(ints), None)
            to = tac.maybe_cast_inputs(op, torch.tensor(f32),
                                       torch.tensor(ints), None)
            assert to[2] is None and jo[2] is None
            for j, t in zip(jo[:2], to[:2]):
                assert str(j.dtype) == str(t.dtype).split(".")[-1], op
                _close(_np(t), _np(j))
    assert not tac.amp_state().enabled
    assert tac.white_list() == jac.white_list()
    assert tac.black_list() == jac.black_list()
    assert tac.amp_guard is tac.auto_cast


def test_sdpa_under_auto_cast_matches_jax():
    """fp32 q, k, v into ``scaled_dot_product_attention`` inside
    auto_cast(bfloat16): both cast them to bf16 at the "attention" call
    site and return bf16 within 2e-2 of each other."""
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(2, 32, 4, 32).astype(np.float32) for _ in range(3))
    with jamp.auto_cast(dtype="bfloat16"):
        want = JF.scaled_dot_product_attention(
            *(jnp.asarray(x) for x in (q, k, v)), is_causal=True,
            training=False)
    with amp.auto_cast(dtype="bfloat16"):
        got = tF.scaled_dot_product_attention(
            *(torch.tensor(x) for x in (q, k, v)), is_causal=True,
            training=False)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(_np(got), _np(want), 2e-2)
    out = tF.scaled_dot_product_attention(
        *(torch.tensor(x) for x in (q, k, v)), is_causal=True,
        training=False)
    assert out.dtype == torch.float32          # outside the region


def test_decorate_casts_the_model_and_device_queries():
    m = torch.nn.Linear(4, 3)
    out = amp.decorate(m, level="O2", dtype="bfloat16")
    assert out is m and m.weight.dtype == torch.bfloat16
    opt = optimizer.SGD(parameters=m)
    ms, opts = amp.decorate([torch.nn.Linear(2, 2)], opt, level="O1")
    assert ms[0].weight.dtype == torch.float32 and opts is opt
    assert amp.is_bfloat16_supported("cpu") and amp.is_float16_supported(
        "cpu")
    if not torch.cuda.is_available():
        assert not amp.is_bfloat16_supported()
        assert not amp.is_float16_supported("cuda")
    with pytest.raises(ValueError, match="amp dtype"):
        with amp.auto_cast(dtype="int8"):
            pass
    assert not tac.amp_state().enabled       # a refused region left no state


# -- GradScaler ---------------------------------------------------------------

class _JaxVec(jnn.Layer):
    def __init__(self, x0):
        super().__init__()
        self.w = self.create_parameter(
            list(x0.shape), dtype="float32", initializer=I.Assign(x0))


# finite (f), inf (i) or nan (n) gradients, step by step
SCRIPT = "ffiffnifffiiff"


def test_grad_scaler_matches_jax_over_a_scripted_sequence():
    """Scaled gradients through unscale_, step and update over finite, inf
    and NaN steps (dynamic scaling: incr every 3 good steps, decr after 2
    bad ones): the scale, both counters and every skip equal JAX's, the
    parameters within 1e-6; a bad step leaves them as they were bit for
    bit; the state dict round-trips."""
    rs = np.random.RandomState(2)
    x0 = rs.randn(3, 5).astype(np.float32)
    jm = _JaxVec(x0)
    w = torch.tensor(x0)
    kw = dict(init_loss_scaling=2.0 ** 4, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    jo = jopt.SGD(learning_rate=0.1, parameters=jm)
    to = optimizer.SGD(learning_rate=0.1, parameters={"w": w})
    assert ts.scale(torch.tensor(2.0)).item() == float(
        js.scale(jnp.asarray(2.0)))
    for i, kind in enumerate(SCRIPT):
        g = (rs.randn(3, 5) * ts.get_loss_scaling()).astype(np.float32)
        g[1, 2] = {"f": g[1, 2], "i": np.inf, "n": np.nan}[kind]
        before = w.clone()
        if i % 2:          # the unscale_ -> step pattern
            jg = js.unscale_({"w": jnp.asarray(g)})
            tg = ts.unscale_({"w": torch.tensor(g)})
            js.step(jo, jg)
            ts.step(to, tg)
        else:
            js.step(jo, {"w": jnp.asarray(g)})
            ts.step(to, {"w": torch.tensor(g)})
        assert ts._found_inf == js._found_inf == (kind != "f")
        if kind != "f":
            assert torch.equal(w, before)
        js.update()
        ts.update()
        assert ts.state_dict() == js.state_dict(), i
        _close(w, np.asarray(jm.w))
    fresh = amp.GradScaler()
    fresh.load_state_dict(ts.state_dict())
    assert fresh.get_loss_scaling() == ts.get_loss_scaling()
    off = amp.GradScaler(enable=False)
    g = {"w": torch.ones(3, 5)}
    assert off.unscale_(g) is g and off.scale(3.0) == 3.0


def test_grad_scaler_reads_the_bound_gradients():
    """``step(optimizer)`` without a dict reads the bound parameters'
    ``.grad`` (the port's optimizers bind torch parameters)."""
    p = torch.nn.Parameter(torch.ones(4))
    s = amp.GradScaler(init_loss_scaling=8.0)
    opt = optimizer.SGD(learning_rate=0.5, parameters={"p": p})
    s.scale((p * 2.0).sum()).backward()
    s.minimize(opt, None)
    torch.testing.assert_close(p.detach(), torch.zeros(4))


# -- debugging ----------------------------------------------------------------

def test_check_numerics_matches_jax(capsys):
    """Raise on NaN/Inf (the message JAX's gives), print with
    raise_on_nan=False, pass through non-float leaves and trees; the
    tensor checker in abort mode raises even then, and off again it
    prints."""
    bad = np.ones((2, 3), np.float32)
    bad[0, 1] = np.nan
    for lib, conv in ((jdbg, jnp.asarray), (tdbg, torch.tensor)):
        with pytest.raises(FloatingPointError) as e:
            lib.check_numerics(conv(bad), "attn", "logits")
        assert "attn/logits shape=(2, 3)" in str(e.value)
        tree = {"a": conv(np.ones(2, np.float32)), "n": conv(np.arange(3))}
        assert lib.check_numerics(tree)["n"] is tree["n"]
        lib.check_numerics([conv(bad)], raise_on_nan=False)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig())
    try:
        with pytest.raises(FloatingPointError):
            tdbg.check_numerics(torch.tensor(bad), raise_on_nan=False)
    finally:
        tdbg.disable_tensor_checker()
    tdbg.enable_tensor_checker(tdbg.TensorCheckerConfig(
        debug_mode=tdbg.DebugMode.CHECK_NAN_INF))
    tdbg.check_numerics(torch.tensor(bad), raise_on_nan=False)
    tdbg.disable_tensor_checker()


def test_operator_stats_and_compare_accuracy_match_jax(tmp_path, capsys):
    dtypes = ["bfloat16", "float16", "float32", "int32", "bfloat16"]
    with jdbg.collect_operator_stats() as js:
        for d in dtypes:
            jdbg.record_op_dtype(jnp.dtype(d))
    with tdbg.collect_operator_stats() as ts:
        for d in dtypes:
            tdbg.record_op_dtype(getattr(torch, d))
    assert ts.counts == js.counts == {"float16": 1, "bfloat16": 2,
                                      "float32": 1, "other": 1}
    tdbg.record_op_dtype(torch.float32)          # off: not counted
    out = capsys.readouterr().out
    assert out.count("total      calls: 5") == 2
    rs = np.random.RandomState(4)
    a = {"x": rs.randn(4).astype(np.float32), "y": rs.randn(2, 2),
         "z": np.zeros(3)}
    b = {"x": a["x"] + 1e-3, "y": a["y"], "z": np.zeros(4)}
    np.savez(tmp_path / "a.npz", **a)
    np.savez(tmp_path / "b.npz", **b)
    rows = [tdbg.compare_accuracy(str(tmp_path / "a.npz"),
                                  str(tmp_path / "b.npz"),
                                  str(tmp_path / f"{n}.csv"))
            for n in ("t",)]
    want = jdbg.compare_accuracy(str(tmp_path / "a.npz"),
                                 str(tmp_path / "b.npz"),
                                 str(tmp_path / "j.csv"))
    assert rows[0] == want
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()


# -- regularizers and clip_by_norm --------------------------------------------

@pytest.mark.parametrize("name", ["L1Decay", "L2Decay"])
def test_regularizers_match_jax(name):
    rs = np.random.RandomState(5)
    p = rs.randn(7, 3).astype(np.float32)
    p[0, 0] = 0.0
    ours, theirs = getattr(regularizer, name)(0.3), getattr(jreg, name)(0.3)
    _close(ours(torch.tensor(p)), theirs(jnp.asarray(p)))
    _close(ours.grad(torch.tensor(p)), theirs.grad(jnp.asarray(p)))
    assert repr(ours) == repr(theirs)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_norm_matches_jax(max_norm):
    rs = np.random.RandomState(6)
    x = rs.randn(5, 4).astype(np.float32)
    _close(tnclip.clip_by_norm(torch.tensor(x), max_norm),
           jnclip.clip_by_norm(jnp.asarray(x), max_norm))
    assert tnclip.ClipGradByGlobalNorm is optimizer.ClipGradByGlobalNorm
    with pytest.raises(NotImplementedError, match="grad_clip"):
        tnclip.set_gradient_clip(optimizer.ClipGradByNorm(1.0))


# -- incubate.optimizer -------------------------------------------------------

@pytest.mark.parametrize("inner", ["SGD", "Adam"])
def test_lookahead_matches_jax_over_six_steps(inner):
    """k = 3, alpha = 0.5 over an inner SGD or Adam: the parameters after
    each of 6 steps within 1e-6 of JAX's (the slow weights pulled in at
    steps 3 and 6)."""
    rs = np.random.RandomState(7)
    x0 = rs.randn(4, 3).astype(np.float32)
    jm = _JaxVec(x0)
    w = torch.tensor(x0)
    jl = JLookAhead(getattr(jopt, inner)(learning_rate=0.1, parameters=jm),
                    alpha=0.5, k=3)
    tl = tinc.LookAhead(getattr(optimizer, inner)(learning_rate=0.1,
                                                  parameters={"w": w}),
                        alpha=0.5, k=3)
    for _ in range(6):
        g = rs.randn(4, 3).astype(np.float32)
        jl.step({"w": jnp.asarray(g)})
        tl.step({"w": torch.tensor(g)})
        _close(w, np.asarray(jm.w))
    assert tl.get_lr() == 0.1          # the inner optimizer's attributes


class _TorchVec(torch.nn.Module):
    def __init__(self, x0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(x0))


def test_model_average_matches_jax_over_six_steps():
    """Six steps with a window of 2..4 (rate 0.5, so the window restarts):
    the averaged state inside ``apply()`` within 1e-6 of JAX's, the live
    values back after it, and ``restore`` after ``need_restore=False``."""
    rs = np.random.RandomState(8)
    x0 = rs.randn(3, 2).astype(np.float32)
    jm, tm = _JaxVec(x0), _TorchVec(x0)
    kw = dict(average_window_rate=0.5, min_average_window=2,
              max_average_window=4)
    ja = JModelAverage(parameters=jm, **kw)
    ta = tinc.ModelAverage(parameters=tm, **kw)
    for _ in range(6):
        x = rs.randn(3, 2).astype(np.float32)
        jm.set_state_dict({"w": jnp.asarray(x)})
        with torch.no_grad():
            tm.w.copy_(torch.tensor(x))
        ja.step()
        ta.step()
        assert ta._n == ja._n
    live = tm.w.detach().clone()
    with ja.apply(), ta.apply():
        _close(tm.w.detach(), np.asarray(jm.w))
        assert not torch.equal(tm.w.detach(), live)
    assert torch.equal(tm.w.detach(), live)
    with ta.apply(need_restore=False):
        pass
    ta.restore()
    assert torch.equal(tm.w.detach(), live)


def test_incubate_optimizer_names():
    assert tinc.LBFGS is optimizer.LBFGS
    with pytest.raises(AttributeError, match="Trainer"):
        tinc.GradientMergeOptimizer
