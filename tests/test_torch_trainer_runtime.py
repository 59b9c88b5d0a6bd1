"""The port's trainer runtime against the JAX package's ``Trainer``, on
the CPU, over the tiny Llama (naive loss head) with the same weights and
the same seeded token stream through each package's DataLoader:
checkpoints and resume, and the anomaly guard's skip and rollback (the
superstep, offload, schedulers, the optimizer-state bridge and the
preemption telemetry are in ``tests/test_torch_trainer_state.py``).

Tolerances: every loss and parameter within 1e-4 of the JAX trainer's
(fp32, two frameworks' matmul orders); bit for bit within the port (a
resumed or a skipped run against the port's own uninterrupted one).
"""

import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu.resilience import AnomalyGuard as JaxGuard
from paddle_tpu.resilience import CheckpointManager as JaxManager
from paddle_tpu.resilience import PreemptionGuard as JaxPreemption
from paddle_tpu.resilience import TrainingPreempted as JaxPreempted
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.resilience import (AnomalyGuard, CheckpointManager,
                                         PreemptionGuard, TrainingPreempted)
from torch_trainer_runtime_common import (  # noqa: F401
    _close, bit_equal, jax_close, loader, ours, params, sd, theirs)

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
