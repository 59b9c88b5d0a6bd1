"""The port's trainer runtime against the JAX package's ``Trainer``, on
the CPU, over the tiny Llama (naive loss head) with the same weights and
the same seeded token stream: the superstep, optimizer-state offload,
the sixteen learning-rate schedulers' ``lr_of``, the optimizer-state
bridge, the preemption telemetry and the snapshot buffers (checkpoints,
resume and the anomaly guard are in
``tests/test_torch_trainer_runtime.py``).

Tolerances: every loss and parameter within 1e-4 of the JAX trainer's
(fp32, two frameworks' matmul orders); bit for bit within the port (a
superstep run against the port's own K = 1 run); ``lr_of`` exact where
the schedule is arithmetic and within 4 fp32 ulps (or 1e-10) where it
takes an exp, a power or a cosine (numpy's and XLA's implementations
differ in the last bits).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import nn as jnn
from paddle_tpu.nn.layer import Layer
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.resilience import CheckpointManager as JaxManager
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import opt_state_from_jax
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.resilience import (CheckpointManager, PreemptionGuard,
                                         TrainingPreempted)
from torch_trainer_runtime_common import (  # noqa: F401
    B, Tokens, _close, bit_equal, jax_close, loader, ours, params, sd,
    theirs)

def held_bytes(w):
    """The bytes the checkpoint writer's snapshot buffers hold."""
    return sum(b.numel() * b.element_size() for b in w._buffers.values())

# -- the superstep -----------------------------------------------------------------

class _Reg(Layer):
    def __init__(self):
        super().__init__()
        self.l1 = jnn.Linear(4, 1)

    def forward(self, x, y):
        return jnp.mean((self.l1(x) - y) ** 2)


def _jax_cadence(K, tmp):
    """The steps the JAX trainer commits for ``K`` (save interval 3, 8
    steps), on a small regression model: the cadence depends on K, the
    interval and the target only."""
    jpt.seed(0)
    rs = np.random.RandomState(0)
    xs = rs.randn(64, 4).astype(np.float32)
    dl = jio.DataLoader(jio.TensorDataset([xs, xs[:, :1]]), batch_size=4,
                        collate_fn=lambda it: {
                            "x": np.stack([i[0] for i in it]),
                            "y": np.stack([i[1] for i in it])})
    m = _Reg()
    tr = JaxTrainer(m, JaxSGD(learning_rate=0.05, parameters=m))
    mgr = JaxManager(tmp, save_interval_steps=3, keep_last_n=10)
    tr.fit(dl, 8, log_every=1, checkpoint_manager=mgr, steps_per_dispatch=K)
    return mgr.committed_steps()


@pytest.mark.parametrize("K", [1, 2, 4])
def test_superstep_bit_exact_with_the_jax_cadence(sd, tmp_path, K):
    """steps_per_dispatch=K: the same losses and parameters as K=1 bit for
    bit, the host reading losses once per drain, and the checkpoints
    committed at the steps the JAX trainer commits for K."""
    ref = ours(sd)
    h_ref = ref.fit(loader(tio), 8, log_every=1)
    tr = ours(sd)
    mgr = CheckpointManager(str(tmp_path / "p"), save_interval_steps=3,
                            keep_last_n=10, async_save=True)
    hist = tr.fit(loader(tio), 8, log_every=1, checkpoint_manager=mgr,
                  steps_per_dispatch=K)
    assert [m.loss for m in hist] == [m.loss for m in h_ref]
    assert [m.step for m in hist] == list(range(1, 9))
    assert bit_equal(params(tr), params(ref))
    assert mgr.committed_steps() == _jax_cadence(K, str(tmp_path / "j"))
    assert tr.dispatch_stats["dispatches"] == -(-8 // K)
    if K > 1:
        assert tr.dispatch_stats["loss_reads"] < 8
    # the async saves' host buffers do not outlive the fit
    assert held_bytes(ckpt.writer()) == 0


# -- optimizer-state offload -------------------------------------------------------

def test_offload_equals_no_offload(sd):
    """offload_opt_state=True (here the parameters are on the CPU, so the
    state stays in place; the card test streams it) trains as without;
    an optimizer flag set later is adopted; place_opt_state round-trips."""
    from paddle_tpu_torch.optimizer import place_opt_state
    ref = ours(sd)
    ref.fit(loader(tio), 4, log_every=2)
    tr = ours(sd, offload_opt_state=True)
    assert tr._offload and tr.opt_state is not None
    tr.fit(loader(tio), 4, log_every=2)
    assert bit_equal(params(tr), params(ref))
    late = ours(sd)
    late.optimizer._offload_opt_state = True
    late.fit(loader(tio), 4, log_every=2)
    assert late._offload and bit_equal(params(late), params(ref))
    st = place_opt_state(ref.opt_state, ref.params, "device")
    assert st["slots"].keys() == ref.opt_state["slots"].keys()
    with pytest.raises(ValueError):
        place_opt_state(ref.opt_state, ref.params, "disk")


# -- schedulers and the optimizer-state bridge ----------------------------------------

def _schedulers(m):
    return {
        "NoamDecay": m.NoamDecay(512, 4, learning_rate=2.0),
        "PiecewiseDecay": m.PiecewiseDecay([3, 7], [0.1, 0.05, 0.01]),
        "NaturalExpDecay": m.NaturalExpDecay(0.1, 0.3),
        "ExponentialDecay": m.ExponentialDecay(0.1, 0.9),
        "InverseTimeDecay": m.InverseTimeDecay(0.1, 0.5),
        "PolynomialDecay": m.PolynomialDecay(0.1, 4, power=1.5, cycle=True),
        "LinearWarmup": m.LinearWarmup(m.CosineAnnealingDecay(1e-3, 10, 1e-5),
                                       3, 0.0, 1e-3),
        "CosineAnnealingDecay": m.CosineAnnealingDecay(0.1, 7, 0.001),
        "StepDecay": m.StepDecay(0.1, 3, 0.5),
        "MultiStepDecay": m.MultiStepDecay(0.1, [2, 5, 9], 0.3),
        "LambdaDecay": m.LambdaDecay(0.1, lambda e: 0.95 ** e),
        "ReduceOnPlateau": m.ReduceOnPlateau(0.1, patience=1),
        "OneCycleLR": m.OneCycleLR(0.1, 12),
        "CyclicLR": m.CyclicLR(0.01, 0.1, 3, mode="triangular2"),
        "CosineAnnealingWarmRestarts": m.CosineAnnealingWarmRestarts(
            0.1, 3, 2, 0.001),
        "LinearLR": m.LinearLR(0.1, 6),
        "LinearWarmup_stateful": m.LinearWarmup(m.ReduceOnPlateau(0.05), 2,
                                                0.0, 0.05),
        "fluid_functions": [
            m.noam_decay(64, 5), m.exponential_decay(0.1, 3, 0.5, True),
            m.natural_exp_decay(0.1, 3, 0.5), m.inverse_time_decay(0.1, 2, 1.),
            m.polynomial_decay(0.1, 5), m.cosine_decay(0.1, 2, 6),
            m.piecewise_decay([2], [0.1, 0.01]),
            m.linear_lr_warmup(0.1, 3, 0.0, 0.1)],
    }


TRANSCENDENTAL = {"NoamDecay", "NaturalExpDecay", "ExponentialDecay",
                  "PolynomialDecay", "LinearWarmup", "CosineAnnealingDecay",
                  "StepDecay", "MultiStepDecay", "fluid_functions"}


@pytest.mark.parametrize("name", sorted(_schedulers(lr)))
def test_lr_of_matches_jax(name):
    """The rate each step applies: the port's fp32 lr_of against the JAX
    scheduler's lr_of rounded to fp32 (what its trainer applies), over 40
    steps, and get_lr() stepped side by side."""
    ours_s, theirs_s = _schedulers(lr)[name], _schedulers(jlr)[name]
    if not isinstance(ours_s, list):
        ours_s, theirs_s = [ours_s], [theirs_s]
    for o, t in zip(ours_s, theirs_s):
        assert o.functional == getattr(t, "functional", False)
        for step in range(40):
            got = o.lr_of(step)
            want = float(np.float32(np.asarray(t.lr_of(step))))
            if name in TRANSCENDENTAL:
                assert abs(got - want) <= max(
                    4 * float(np.spacing(np.float32(want))), 1e-10), step
            else:
                assert got == want, step
            assert o.get_lr() == pytest.approx(t.get_lr(), rel=1e-12)
            o.step(*([1.0 + step % 3] if name == "ReduceOnPlateau" else []))
            t.step(*([1.0 + step % 3] if name == "ReduceOnPlateau" else []))


def test_opt_state_from_jax_continues_a_jax_run(sd):
    """Two JAX steps, then both trainers continue from that state (the
    port's parameters from the JAX model, its optimizer state through
    opt_state_from_jax): two more steps agree within 1e-4."""
    jtr = theirs(sd)
    batches = list(jio.DataLoader(Tokens(), batch_size=B))
    for b in batches[:2]:
        jtr.train_step(b)
    state = {"step": np.asarray(jtr.opt_state["step"]),
             "master": {k: np.asarray(v)
                        for k, v in jtr.opt_state.get("master", {}).items()},
             "slots": {k: {sk: np.asarray(sv) for sk, sv in e.items()}
                       for k, e in jtr.opt_state["slots"].items()}}
    tr = ours({k: np.asarray(v) for k, v in jtr.params.items()})
    tr.set_state_dict({"step": 2, "params": dict(tr.params),
                       "opt_state": opt_state_from_jax(state, tr.params)})
    tr.optimizer.lr_scheduler.step(2)
    assert tr.opt_state["step"] == 2
    tb = list(tio.DataLoader(Tokens(), batch_size=B))
    for b, jb in zip(tb[2:4], batches[2:4]):
        _close(tr.train_step(b), jtr.train_step(jb))
    jax_close(params(tr), jtr)
    bad = dict(state, slots={**state["slots"], "nope": {}})
    with pytest.raises(ValueError, match="nope"):
        opt_state_from_jax(bad, tr.params)


def test_preemption_telemetry_and_flight_dump(sd, tmp_path):
    """The preemption exit counts pt_preemptions_total, books the wind-down
    as preemption_lost and writes the flight recorder's dump next to the
    checkpoints."""
    rec = obs.flight_recorder.recorder()
    obs.enable(flight_dir=str(tmp_path / "flight"))
    led = obs.ledger()
    led.reset()
    try:
        tr = ours(sd)
        guard = PreemptionGuard()
        mgr = CheckpointManager(str(tmp_path / "c"), save_interval_steps=10)
        with pytest.raises(TrainingPreempted):
            tr.fit(loader(tio), 8, log_every=1, checkpoint_manager=mgr,
                   preemption_guard=guard,
                   on_metrics=lambda m: guard.trigger() if m.step >= 2
                   else None)
        assert mgr.committed_steps() == [2]
        assert obs.REGISTRY.counter("pt_preemptions_total").value() >= 1
        assert led.totals()["preemption_lost"] > 0
        flight = os.path.join(mgr.root, "_flight")
        reasons = []
        for name in os.listdir(flight):
            with open(os.path.join(flight, name)) as f:
                reasons.append(json.load(f)["reason"])
        assert reasons == ["preemption"]
    finally:
        obs.disable()
        rec.dir = "."


def test_fit_frees_the_snapshot_buffers_when_it_raises(sd, tmp_path):
    """A fit that ends by raising (here a preemption after async saves)
    leaves none of the async saves' host buffers behind."""
    tr = ours(sd)
    guard = PreemptionGuard()
    mgr = CheckpointManager(str(tmp_path / "c"), save_interval_steps=1,
                            keep_last_n=10, async_save=True)
    real_save = mgr.save
    held = []

    def save(step, tree, **kw):
        out = real_save(step, tree, **kw)
        held.append(held_bytes(ckpt.writer()))
        return out
    mgr.save = save
    with pytest.raises(TrainingPreempted):
        tr.fit(loader(tio), 8, log_every=1, checkpoint_manager=mgr,
               preemption_guard=guard,
               on_metrics=lambda m: guard.trigger() if m.step >= 3
               else None)
    assert held[:2] == [held[0]] * 2 and held[0] > 0 and held[2] == 0
    assert mgr.committed_steps() == [1, 2, 3]
    assert held_bytes(ckpt.writer()) == 0
