"""The port's launcher, its membership service and rpc
(``paddle_tpu_torch.distributed.{launch,rpc}``) over
``torch.distributed.TCPStore``, in the scenarios the JAX package's
launcher tests run (``tests/test_launch_elastic_tuner.py``,
``tests/test_launch_master.py``, ``tests/test_resilience.py``), and one
2-rank gloo Trainer step started by the launcher against the JAX
unsharded step.

Every test that starts processes bounds its wait, so that a hang fails
that test alone."""

import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from paddle_tpu.distributed.launch import LaunchConfig as JaxLaunchConfig
from paddle_tpu.distributed.launch import build_pod as jax_build_pod
from paddle_tpu_torch.distributed.launch import (LaunchConfig, build_pod,
                                                 launch)
from paddle_tpu_torch.distributed.launch.main import _pod_exit_code
from paddle_tpu_torch.distributed.launch.master import Master
from paddle_tpu_torch.parallel.mesh import pod_bootstrap_env
from torch_dist_workers import ROOT, rpc_add as _add, rpc_boom as _boom
from torch_dist_workers import rpc_child as _rpc_child
from torch_dist_workers import run_ranks
from torch_mesh_refs import (check_step, jax_step, tiny_state, uneven_batch,
                             worker_inputs)

PROC_TIMEOUT_S = 180


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


@pytest.fixture
def pyenv(monkeypatch):
    """Workers started by the launcher find the repository."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))


# -- the pod's environment ----------------------------------------------------

PADDLE_KEYS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
               "PADDLE_LOCAL_RANK", "PADDLE_JOB_ID")


def test_build_pod_env(tmp_path, monkeypatch):
    """Each rank's environment carries torchrun's and Paddle's sources,
    Paddle's as JAX's launcher sets them, and no JAX coordinator; both
    lead pod_bootstrap_env to the same rendezvous."""
    cfg = LaunchConfig(nproc_per_node=3, log_dir=str(tmp_path),
                       master="127.0.0.1:29511")
    pod = build_pod(cfg, "train.py", ["--foo"])
    jpod = jax_build_pod(JaxLaunchConfig(nproc_per_node=3,
                                         log_dir=str(tmp_path),
                                         master="127.0.0.1:29511"),
                         "train.py", ["--foo"])
    assert len(pod.containers) == 3
    envs = [c.env for c in pod.containers]
    for e, je in zip(envs, (c.env for c in jpod.containers)):
        assert {k: e[k] for k in PADDLE_KEYS} == {k: je[k]
                                                  for k in PADDLE_KEYS}
        assert (e["MASTER_ADDR"], e["MASTER_PORT"]) == ("127.0.0.1", "29511")
        assert not any(k.startswith("JAX_") for k in e)
    assert [e["RANK"] for e in envs] == ["0", "1", "2"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "2"]
    assert [e["FLAGS_selected_gpus"] for e in envs] == ["0", "1", "2"]
    assert all(e["WORLD_SIZE"] == "3" for e in envs)
    eps = envs[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == 3 and envs[1]["PADDLE_CURRENT_ENDPOINT"] == eps[1]
    assert pod.containers[0].cmd[-2:] == ["train.py", "--foo"]
    want = {"init_method": "tcp://127.0.0.1:29511", "world_size": 3,
            "rank": 1, "local_rank": 1}
    for drop in ((), ("WORLD_SIZE", "RANK")):
        with monkeypatch.context() as m:
            for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                      "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID"):
                m.delenv(k, raising=False)
            for k, v in envs[1].items():
                if k not in drop:
                    m.setenv(k, v)
            assert pod_bootstrap_env() == want
    # --devices: one card a rank, which the rank sees as card 0
    cfg.devices = "4,5,6"
    envs = [c.env for c in build_pod(cfg, "t.py", []).containers]
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["4", "5", "6"]
    assert [e["FLAGS_selected_gpus"] for e in envs] == ["0", "0", "0"]


@pytest.mark.parametrize("stray", ["0", "0,1,2,3", "7"])
def test_card_from_local_rank_not_a_stray_paddle_flag(monkeypatch, stray):
    """Under torchrun's environment a FLAGS_selected_gpus that a Paddle
    user exported chooses no card: rank 2 of 4 cards takes card 2, and
    shown one card (the launcher's --devices) card 0."""
    import torch
    from paddle_tpu_torch.distributed.compat import ParallelEnv
    from paddle_tpu_torch.parallel.mesh import local_card
    for k in [k for k in os.environ if k.startswith("PADDLE_")]:
        monkeypatch.delenv(k)
    for k, v in {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29512",
                 "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2",
                 "FLAGS_selected_gpus": stray}.items():
        monkeypatch.setenv(k, v)
    local = pod_bootstrap_env()["local_rank"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert local_card(local) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert local_card(local) == 0
    assert ParallelEnv().device_id == int(stray.split(",")[0])


def test_pod_exit_code_resumable_only_when_all_are():
    class C:
        def __init__(self, code):
            self.exit_code = code
    assert _pod_exit_code([C(75), C(75)]) == 75
    assert _pod_exit_code([C(75), C(3)]) == 3


# -- launch, restart, resumable exits -----------------------------------------

def test_launch_runs_workers_and_collects_logs(tmp_path, pyenv):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""
        import os, sys
        rank = os.environ["PADDLE_TRAINER_ID"]
        assert os.environ["RANK"] == rank
        print(f"hello from rank {rank}")
        sys.exit(0)
    """))
    cfg = LaunchConfig(nproc_per_node=2, log_dir=str(tmp_path / "log"))
    assert launch(cfg, str(script)) == 0
    logs = sorted(os.listdir(tmp_path / "log"))
    assert logs == ["workerlog.0", "workerlog.1"]
    log0 = (tmp_path / "log" / "workerlog.0").read_text()
    assert "hello from rank 0" in log0


def _counting_script(tmp_path, codes):
    """A worker whose n-th start (counted in a file) exits codes[n]."""
    script = tmp_path / "flaky.py"
    count = tmp_path / "starts"
    script.write_text(textwrap.dedent(f"""
        import os, sys
        p = {str(count)!r}
        n = int(open(p).read()) if os.path.exists(p) else 0
        open(p, "w").write(str(n + 1))
        codes = {list(codes)!r}
        sys.exit(codes[min(n, len(codes) - 1)])
    """))
    return script, count


def test_launch_failure_and_restart(tmp_path):
    script, count = _counting_script(tmp_path, [3, 0])
    cfg = LaunchConfig(nproc_per_node=1, log_dir=str(tmp_path / "log"),
                       max_restarts=2)
    assert launch(cfg, str(script)) == 0
    assert count.read_text() == "2"
    count.unlink()
    cfg0 = LaunchConfig(nproc_per_node=1, log_dir=str(tmp_path / "log2"),
                        max_restarts=0)
    assert launch(cfg0, str(script)) == 3


def test_resumable_exit_relaunched_without_spending_restarts(tmp_path):
    """Exit 75 (a worker that checkpointed on preemption) is relaunched
    under its own budget: with max_restarts 0 two preemptions then a
    success return 0; the preemption budget bounds the relaunches."""
    script, count = _counting_script(tmp_path, [75, 75, 0])
    cfg = LaunchConfig(nproc_per_node=1, log_dir=str(tmp_path / "log"),
                       max_restarts=0)
    assert launch(cfg, str(script)) == 0
    assert count.read_text() == "3"
    count.unlink()
    script, count = _counting_script(tmp_path, [75])
    cfg = LaunchConfig(nproc_per_node=1, log_dir=str(tmp_path / "log2"),
                       max_restarts=0, max_preempt_relaunches=2)
    assert launch(cfg, str(script)) == 75
    assert count.read_text() == "3"


# -- the membership service ---------------------------------------------------

def test_sync_peers_assigns_ranks_by_registration():
    port = _free_port()
    server = Master("127.0.0.1", port, "t1", is_server=True)
    results = {}

    def join(name, delay):
        time.sleep(delay)
        m = Master("127.0.0.1", port, "t1")
        results[name] = m.sync_peers(name, nnodes=3, epoch=0)

    ts = [threading.Thread(target=join, args=(f"pod{i}", 0.1 * i))
          for i in range(1, 3)]
    for t in ts:
        t.start()
    peers, rank = server.sync_peers("pod0", nnodes=3, epoch=0)
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert rank == 0
    assert peers == ["pod0", "pod1", "pod2"]
    assert results["pod1"][1] == 1 and results["pod2"][1] == 2
    assert results["pod1"][0] == peers
    with pytest.raises(TimeoutError):
        server.sync_peers("late", nnodes=4, epoch=1, timeout=0.3)


def test_heartbeat_ttl():
    m = Master("127.0.0.1", _free_port(), "t2", is_server=True)
    m.heartbeat("a")
    assert m.dead_pods(["a", "never-seen"], ttl=5.0) == []
    time.sleep(0.3)
    assert m.dead_pods(["a"], ttl=0.1) == ["a"]
    m.heartbeat("a")
    assert m.dead_pods(["a"], ttl=5.0) == []
    m.start_heartbeat("b", interval=0.05)
    time.sleep(0.2)
    assert set(m.heartbeats(["b", "c"])) == {"b"}
    m.stop_heartbeat()


def test_restart_epoch_watch_and_preempt_counter():
    """A bump is seen by every client; the reason rides a counter, and a
    window mixing a failure with a preemption reads as a failure."""
    port = _free_port()
    m = Master("127.0.0.1", port, "t3", is_server=True)
    c = Master("127.0.0.1", port, "t3")
    e0, p0 = c.restart_epoch(), c.preempt_epochs()
    e1 = m.bump_epoch("preempt")
    assert c.restart_epoch() == e0 + 1 == e1
    assert (c.preempt_epochs() - p0) >= (e1 - e0)
    p1 = c.preempt_epochs()
    m.bump_epoch("preempt")
    e3 = m.bump_epoch()
    assert (c.preempt_epochs() - p1) < (e3 - e1)


def test_client_retries_until_server_up():
    port = _free_port()
    got = {}

    def late_server():
        time.sleep(1.0)
        got["server"] = Master("127.0.0.1", port, "t4", is_server=True)

    t = threading.Thread(target=late_server)
    t.start()
    c = Master("127.0.0.1", port, "t4", connect_retry_s=15.0)
    t.join(timeout=30)
    c.store.set("x", "1")
    assert got["server"].store.get("x") == b"1"
    assert c.try_get("x") == b"1" and c.try_get("y") is None


# -- two pods on localhost ----------------------------------------------------

_WORKER4 = textwrap.dedent("""
    import os, sys
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    env = {k: os.environ[k] for k in ("RANK", "WORLD_SIZE")}
    init_parallel_env(dp=4, backend="gloo", device="cpu")
    assert dist.get_world_size() == 4, env
    x = torch.tensor([float(dist.get_rank())])
    dist.all_reduce(x)
    assert float(x) == 6.0, x
    print("POD4_OK rank", dist.get_rank(), flush=True)
    dist.destroy_process_group()
""")


def _run_controllers(tmp_path, script, max_restarts=0):
    master = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nnodes", "2", "--nproc_per_node", "2", "--master", master,
         "--job_id", "jm", "--max_restarts", str(max_restarts),
         "--log_dir", str(tmp_path / f"log_{tag}"), str(script)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for tag in ("a", "b")]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=PROC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    logs = ""
    for d in ("log_a", "log_b"):
        for f in sorted(os.listdir(tmp_path / d)):
            logs += (tmp_path / d / f).read_text()
    return [p.returncode for p in procs], outs, logs


def test_two_pods_bootstrap_one_group(tmp_path):
    """Two controllers ("hosts") of 2 workers each meet through the
    membership store; the 4 workers form one gloo group through the
    environment (node 0's coordinator port, not the master's)."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER4)
    codes, outs, logs = _run_controllers(tmp_path, script)
    assert codes == [0, 0], (codes, outs, logs[-3000:])
    assert logs.count("POD4_OK") == 4, logs[-3000:]


def test_worker_kill_restarts_both_pods(tmp_path):
    """Worker 3 (pod B) SIGKILLs itself once: pod B's controller bumps
    the restart epoch, pod A sees it and restarts too, and the second
    epoch completes on all 4 workers."""
    script = tmp_path / "flaky.py"
    script.write_text(textwrap.dedent("""
        import os, signal, time
        rank = os.environ["PADDLE_TRAINER_ID"]
        marker = os.path.join({d!r}, "died_once")
        if rank == "3" and not os.path.exists(marker):
            open(marker, "w").write("x")
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(1.0)
        print("EPOCH_WORKER_OK", rank, flush=True)
    """).format(d=str(tmp_path)))
    codes, outs, logs = _run_controllers(tmp_path, script, max_restarts=2)
    assert codes == [0, 0], (codes, outs)
    assert (tmp_path / "died_once").exists()
    ctrl = "".join(outs)
    assert "signaling restart" in ctrl
    assert "peer signaled restart" in ctrl
    for r in "0123":
        assert f"EPOCH_WORKER_OK {r}" in logs, logs[-3000:]


# -- rpc ----------------------------------------------------------------------

def test_rpc_single_process_loopback():
    from paddle_tpu_torch.distributed import rpc
    rpc.init_rpc("worker0", rank=0, world_size=1)
    try:
        info = rpc.get_worker_info()
        assert info.name == "worker0" and info.rank == 0
        assert rpc.rpc_sync("worker0", _add, args=(2, 3)) == 5
        fut = rpc.rpc_async("worker0", _add, args=(10, 20))
        assert fut.result(timeout=30) == 30
        with pytest.raises(ValueError, match="remote failure"):
            rpc.rpc_sync("worker0", _boom)
        assert len(rpc.get_all_worker_infos()) == 1
    finally:
        rpc.shutdown()


def test_rpc_cross_process():
    import multiprocessing as mp
    from paddle_tpu_torch.distributed import rpc
    port = _free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_rpc_child, args=(port, q))
    p.start()
    try:
        rpc.init_rpc("w0", rank=0, world_size=2,
                      master_endpoint=f"127.0.0.1:{port}")
        try:
            assert q.get(timeout=PROC_TIMEOUT_S) == 15
            assert rpc.rpc_sync("w1", _add, args=(1, 1)) == 2
            assert [w.name for w in rpc.get_all_worker_infos()] == ["w0",
                                                                     "w1"]
        finally:
            rpc.shutdown()
    finally:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
    assert p.exitcode == 0


# -- a Trainer step started by the launcher -----------------------------------

def test_launcher_gloo_trainer_step_matches_jax(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2``
    starts two gloo ranks that join through its environment; their dp2
    Trainer step (loss, gradients, norm, parameters) equals the JAX
    unsharded step (1e-4)."""
    sd = tiny_state()
    batches = [uneven_batch()]
    ref = {}
    outs = run_ranks(
        2, [{"fn": "train", "key": "dp",
             "args": {"mesh": {"dp": 2}, "opt": "sgd"}}],
        worker_inputs(sd, batches), tmp_path, launcher=True,
        during=lambda: ref.update(jax_step(sd, batches, opt="sgd", lr=0.1)))
    assert sorted(os.listdir(tmp_path / "log")) == ["workerlog.0",
                                                    "workerlog.1"]
    check_step(outs, "dp", ref)
