"""The port's trainer runtime against the JAX package's ``Trainer``, on
the CPU, over the tiny Llama (naive loss head) with the same weights and
the same seeded token stream through each package's DataLoader:
checkpoints and resume, the anomaly guard's skip and rollback, the
preemption guard, the superstep, optimizer-state offload, the sixteen
learning-rate schedulers' ``lr_of`` and the optimizer-state bridge.

Tolerances: every loss and parameter within 1e-4 of the JAX trainer's
(fp32, two frameworks' matmul orders); bit for bit within the port (a
resumed, a skipped or a superstep run against the port's own
uninterrupted one); ``lr_of`` exact where the schedule is arithmetic and
within 4 fp32 ulps (or 1e-10) where it takes an exp, a power or a cosine
(numpy's and XLA's implementations differ in the last bits).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu import io as jio
from paddle_tpu import nn as jnn
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn.layer import Layer
from paddle_tpu.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.resilience import AnomalyGuard as JaxGuard
from paddle_tpu.resilience import CheckpointManager as JaxManager
from paddle_tpu.resilience import PreemptionGuard as JaxPreemption
from paddle_tpu.resilience import TrainingPreempted as JaxPreempted
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import opt_state_from_jax, state_dict_from_jax
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr
from paddle_tpu_torch.resilience import (AnomalyGuard, CheckpointManager,
                                         PreemptionGuard, TrainingPreempted)
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


# -- checkpoints and resume ------------------------------------------------------

def test_fit_with_manager_then_resume_matches_jax_and_itself(sd, tmp_path):
    """8 steps under CheckpointManager(save_interval_steps=3, async); a run
    preempted at step 5 (one final sync save, exit code 75); a fresh
    Trainer over other weights resumes it with resume="auto". The resumed
    losses and final state equal the uninterrupted run's bit for bit and
    the JAX trainer's doing the same within 1e-4; both frameworks commit
    the same steps."""
    ref = ours(sd)
    mgr = CheckpointManager(str(tmp_path / "ref"), save_interval_steps=3,
                            async_save=True)
    h_ref = ref.fit(loader(tio), 8, log_every=1, checkpoint_manager=mgr)
    jref = theirs(sd)
    jmgr = JaxManager(str(tmp_path / "jref"), save_interval_steps=3,
                      async_save=True)
    jh = jref.fit(loader(jio), 8, log_every=1, checkpoint_manager=jmgr)
    _close([m.loss for m in h_ref], [m.loss for m in jh])
    jax_close(params(ref), jref)
    assert mgr.committed_steps() == jmgr.committed_steps() == [3, 6, 8]

    root = str(tmp_path / "run")
    a = ours(sd)
    guard = PreemptionGuard()
    with pytest.raises(TrainingPreempted) as ei:
        a.fit(loader(tio), 8, log_every=1, preemption_guard=guard,
              checkpoint_manager=CheckpointManager(root, save_interval_steps=3,
                                                   async_save=True),
              on_metrics=lambda m: guard.trigger() if m.step >= 5 else None)
    assert ei.value.code == 75
    b = ours(sd, weights=False)
    assert not bit_equal(params(b), params(ref))
    mgr_b = CheckpointManager(root, save_interval_steps=3, async_save=True)
    h_b = b.fit(loader(tio), 8, log_every=1, checkpoint_manager=mgr_b,
                resume="auto")
    assert [m.step for m in h_b] == [6, 7, 8]
    assert [m.loss for m in h_b] == [m.loss for m in h_ref][5:]
    assert bit_equal(params(b), params(ref))
    for k, slots in ref.opt_state["slots"].items():
        for sk, t in slots.items():
            assert torch.equal(b.opt_state["slots"][k][sk], t)
    assert b.opt_state["step"] == ref.opt_state["step"] == 8
    assert b.optimizer.lr_scheduler.state_dict() == \
        ref.optimizer.lr_scheduler.state_dict()
    assert mgr_b.committed_steps() == [5, 6, 8]

    jroot = str(tmp_path / "jrun")
    ja = theirs(sd)
    jguard = JaxPreemption()
    with pytest.raises(JaxPreempted):
        ja.fit(loader(jio), 8, log_every=1, preemption_guard=jguard,
               checkpoint_manager=JaxManager(jroot, save_interval_steps=3,
                                             async_save=True),
               on_metrics=lambda m: jguard.trigger() if m.step >= 5 else None)
    jb = theirs(sd)
    jh_b = jb.fit(loader(jio), 8, log_every=1, resume="auto",
                  checkpoint_manager=JaxManager(jroot, save_interval_steps=3,
                                                async_save=True))
    _close([m.loss for m in h_b], [m.loss for m in jh_b])
    jax_close(params(b), jb)


def test_resume_restores_adaptive_lr_value_and_creates_state(sd, tmp_path):
    """ReduceOnPlateau's rate is a stored VALUE; a restore before any step
    creates the optimizer state and copies into it."""
    a = ours(sd)
    a.optimizer.set_lr_scheduler(lr.ReduceOnPlateau(learning_rate=0.05))
    a.optimizer.lr_scheduler.last_lr = 0.005
    a.fit(loader(tio), 3, log_every=1, checkpoint_manager=CheckpointManager(
        str(tmp_path), save_interval_steps=3))
    b = ours(sd, weights=False)
    b.optimizer.set_lr_scheduler(lr.ReduceOnPlateau(learning_rate=0.05))
    assert b.opt_state is None
    b.fit(loader(tio), 3, log_every=1, resume="auto",
          checkpoint_manager=CheckpointManager(str(tmp_path)))
    assert b.optimizer.get_lr() == 0.005
    assert bit_equal(params(b), params(a))
    assert b.opt_state["step"] == 3


# -- the anomaly guard -------------------------------------------------------------

def test_skip_undoes_the_poisoned_step_like_jax(sd):
    """A NaN batch at index 3 under policy="skip" (donate=False): the step
    is undone, the cursor moves past the batch, and the run ends where a
    run that never saw the batch ends, bit for bit; the JAX trainer does
    the same within 1e-4."""
    tr = ours(sd, donate=False)
    guard = AnomalyGuard(policy="skip", warmup_steps=100)
    data = loader(tio, poison_at=3)
    hist = tr.fit(data, 6, log_every=1, anomaly_guard=guard)
    assert guard.skips == 1 and tr._step == 6
    assert data.state_dict() == {"batches_served": 7}
    clean = [b for i, b in enumerate(loader(tio)) if i != 3][:6]
    ref = ours(sd)
    h_ref = ref.fit(iter(clean), 6, log_every=1)
    assert bit_equal(params(tr), params(ref))
    assert [m.loss for m in hist] == [m.loss for m in h_ref]
    jtr = theirs(sd)
    jguard = JaxGuard(policy="skip", warmup_steps=100)
    jh = jtr.fit(loader(jio, poison_at=3), 6, log_every=1,
                 anomaly_guard=jguard)
    assert jguard.skips == 1
    _close([m.loss for m in hist], [m.loss for m in jh])
    jax_close(params(tr), jtr)


def test_rollback_replays_from_the_checkpoint_cursor_like_jax(sd, tmp_path):
    """A NaN batch at index 4 under policy="rollback" with a manager
    saving every 3 steps: the state is restored from step 3, the loader
    replays from the checkpointed cursor (the batch comes back clean), the
    goodput ledger books rollback_wasted, and the run ends on the
    uninterrupted run's state bit for bit and the JAX trainer's within
    1e-4."""
    led = obs.ledger()
    led.reset()
    tr = ours(sd)
    guard = AnomalyGuard(policy="rollback", warmup_steps=100)
    tr.fit(loader(tio, poison_at=4), 6, log_every=1, anomaly_guard=guard,
           checkpoint_manager=CheckpointManager(str(tmp_path / "p"),
                                                save_interval_steps=3))
    assert guard.rollbacks == 1 and tr._step == 6
    assert led.totals()["rollback_wasted"] > 0
    ref = ours(sd)
    ref.fit(loader(tio), 6, log_every=1)
    assert bit_equal(params(tr), params(ref))
    jtr = theirs(sd)
    jguard = JaxGuard(policy="rollback", warmup_steps=100)
    jtr.fit(loader(jio, poison_at=4), 6, log_every=1, anomaly_guard=jguard,
            checkpoint_manager=JaxManager(str(tmp_path / "j"),
                                          save_interval_steps=3))
    assert jguard.rollbacks == 1
    jax_close(params(tr), jtr)


def test_fit_argument_checks_match_jax(sd):
    tr = ours(sd)
    with pytest.raises(ValueError, match="checkpoint_manager"):
        tr.fit([], 1, resume="auto")
    with pytest.raises(ValueError, match="donate=False"):
        tr.fit([], 1, anomaly_guard=AnomalyGuard(policy="skip"))
    tr = ours(sd, donate=False)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        tr.fit([], 1, anomaly_guard=AnomalyGuard(policy="skip"),
               steps_per_dispatch=2)


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
