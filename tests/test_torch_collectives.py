"""The port's collectives, device mesh, topology, reshard registry and
parameter specs (``paddle_tpu_torch.distributed`` / ``parallel``) on 4
gloo ranks against the JAX package on 4 of its virtual CPU devices.

JAX's eager collectives take a rank-major global array; the port's take
each rank's own tensor: rank r's result here is slice r of JAX's. The
ranks run once per module (``tests/torch_dist_workers.py``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.distributed import communication as jc
from paddle_tpu.distributed.topology import \
    HybridCommunicateGroup as JaxHCG
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.parallel import api as japi
from paddle_tpu.parallel.mesh import HybridMesh as JaxMesh
from paddle_tpu.parallel.reshard import reshard_with_registry as jreshard
from paddle_tpu_torch.distributed.topology import CommunicateTopology
from torch_dist_workers import run_ranks

WORLD = 4
MESHES = [dict(dp=4), dict(dp=2, tp=2), dict(fsdp=2, sep=2),
          dict(dp=2, fsdp=2), dict(fsdp=2, tp=2), dict(sep=2, tp=2),
          dict(dp=4, ep=2), dict(dp=2, ep=2, tp=2)]
PAIRS = [("S0", "R"), ("R", "S1"), ("S0", "S1"), ("P", "R"), ("P", "S0"),
         ("R", "P")]


def _inputs():
    rs = np.random.RandomState(0)
    return {"x": rs.randn(WORLD, 8, 3).astype(np.float32),
            "payload": rs.randn(WORLD, WORLD, 2, 3).astype(np.float32),
            "w": rs.randn(WORLD, 8, 3).astype(np.float32),
            "xr": rs.randn(4, 6).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inp = _inputs()
    scen = [{"fn": "collectives", "key": "c", "args": {"mesh": {"dp": 4}}},
            {"fn": "specs", "key": "s", "args": {"meshes": MESHES}},
            {"fn": "reshard", "key": "r",
             "args": {"mesh": {"dp": 2, "tp": 2}, "pairs": PAIRS}}]
    outs = run_ranks(WORLD, scen, inp, tmp_path_factory.mktemp("coll"))
    return inp, outs


def _jmesh(**deg):
    return JaxMesh.build(devices=jax.devices()[:WORLD], **deg)


def _rank_major(hm, fn, x, axis="dp"):
    with hm:
        return np.asarray(fn(jc.rank_view(jnp.asarray(x), axis)))


OPS = {"sum": jc.ReduceOp.SUM, "max": jc.ReduceOp.MAX,
       "min": jc.ReduceOp.MIN, "avg": jc.ReduceOp.AVG}


@pytest.mark.parametrize("op", sorted(OPS))
def test_all_reduce_matches_jax(ranks, op):
    inp, outs = ranks
    hm = _jmesh(dp=4)
    want = _rank_major(hm, lambda a: jc.all_reduce(a, OPS[op], "dp"),
                       inp["x"])
    for r in range(WORLD):
        np.testing.assert_allclose(outs[r][f"c/all_reduce_{op}"], want,
                                   rtol=1e-6, atol=1e-6)


def _per_rank(jarr):
    """{device id: that device's shard} of a JAX array."""
    return {s.device.id: np.asarray(s.data) for s in jarr.addressable_shards}


@pytest.mark.parametrize("name", ["reduce_scatter", "alltoall", "broadcast",
                                  "reduce", "scatter", "send_to",
                                  "ppermute_ring", "ppermute_pairs",
                                  "send_recv", "batch_isend_irecv"])
def test_rank_major_collectives_match_jax(ranks, name):
    """Rank r's result is slice r of JAX's rank-major result."""
    inp, outs = ranks
    hm = _jmesh(dp=4)
    x = inp["x"]
    ring = [(i, (i + 1) % WORLD) for i in range(WORLD)]
    with hm:
        jx = jc.rank_view(jnp.asarray(x), "dp")
        want = {
            "reduce_scatter": lambda: jc.reduce_scatter(jx, group="dp"),
            "alltoall": lambda: jc.alltoall(jx, group="dp"),
            "broadcast": lambda: jc.broadcast(jx, src=1, group="dp"),
            "reduce": lambda: jc.reduce(jx, dst=2, group="dp"),
            "scatter": lambda: jc.scatter(jc.rank_view(jnp.asarray(
                inp["payload"]), "dp"), src=1, group="dp"),
            "send_to": lambda: jc.send_to(jx, dst=3, src=1, group="dp"),
            "ppermute_ring": lambda: jc.batch_isend_irecv(jx, ring, "dp"),
            "ppermute_pairs": lambda: jc.batch_isend_irecv(
                jx, [(0, 2), (2, 0)], "dp"),
            "send_recv": lambda: jc.batch_isend_irecv(jx, ring, "dp"),
            "batch_isend_irecv": lambda: jc.batch_isend_irecv(jx, ring,
                                                              "dp"),
        }[name]()
        want = np.asarray(want)
    for r in range(WORLD):
        np.testing.assert_allclose(outs[r][f"c/{name}"].reshape(
            want[r].shape), want[r], rtol=1e-6, atol=1e-6)


def test_all_gather_and_gather_match_jax(ranks):
    inp, outs = ranks
    hm = _jmesh(dp=4)
    want = _rank_major(hm, lambda a: jc.all_gather(a, "dp"), inp["x"])
    for r in range(WORLD):
        np.testing.assert_allclose(outs[r]["c/all_gather"], want)
    np.testing.assert_allclose(outs[0]["c/gather"], want)
    assert all(outs[r]["c/gather"].size == 0 for r in range(1, WORLD))


def test_differentiable_collectives_values_and_transposes(ranks):
    """Each differentiable form's value and the gradient of sum(w * f(x))
    equal what its stated transpose gives on the rank-major arrays."""
    inp, outs = ranks
    x, w = inp["x"], inp["w"]

    def close(a, b):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    n = WORLD
    tot_w = w.sum(0)
    for r in range(n):
        o = {k[len("c/diff_"):]: v for k, v in outs[r].items()
             if k.startswith("c/diff_")}
        close(o["copy_y"], x[r])
        close(o["copy_g"], tot_w)
        close(o["reduce_y"], x.sum(0))
        close(o["reduce_g"], w[r])
        close(o["gather_y"], np.concatenate(x, 0))
        # rank j weighs the gathered rows by w[j] tiled: rank r's block of
        # the reduce-scatter is the sum of the w[j]
        close(o["gather_g"], tot_w)
        close(o["scatter_y"], x[r][r * 2:(r + 1) * 2])
        close(o["scatter_g"], np.concatenate(
            [w[j][:2] for j in range(n)]))
        close(o["rs_y"], x.sum(0)[r * 2:(r + 1) * 2])
        close(o["rs_g"], np.concatenate(
            [w[j][:2] for j in range(n)]))
        close(o["a2a_y"], np.concatenate(
            [x[j][r * 2:(r + 1) * 2] for j in range(n)]))
        close(o["a2a_g"], np.concatenate(
            [w[j][r * 2:(r + 1) * 2] for j in range(n)]))
        close(o["shift_y"], x[(r - 1) % n])
        close(o["shift_g"], w[(r + 1) % n])


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_mesh_and_hcg_queries_match_jax(ranks, i):
    """HybridMesh axes and sizes, the HCG degree queries, the topology
    and each rank's groups against JAX's mesh of the same degrees."""
    _, outs = ranks
    deg = MESHES[i]
    hm = _jmesh(**deg)
    hcg = JaxHCG(hm)
    got = json.loads(str(outs[0][f"s/mesh{i}"]))
    assert got["axes"] == list(hm.mesh.axis_names)
    assert got["shape"] == [hm.mesh.shape[a] for a in hm.mesh.axis_names]
    assert got["dp"] == hcg.get_data_parallel_world_size()
    assert got["mp"] == hcg.get_model_parallel_world_size()
    assert got["pp"] == hcg.get_pipe_parallel_world_size()
    assert got["sharding"] == hcg.get_sharding_parallel_world_size()
    assert got["sep"] == hcg.get_sep_parallel_world_size()
    assert got["ep"] == hm.get_expert_parallel_world_size()
    assert got["nproc"] == hm.nproc
    jt = hcg.topology()
    assert got["topo_dims"] == [jt.get_dim(n) for n in
                                jt.get_hybrid_group_names()]
    assert got["comm_model"] == jt.get_comm_list("model")
    assert got["comm_data"] == jt.get_comm_list("data")
    ids = np.vectorize(lambda d: d.id)(hm.mesh.devices)
    for r in range(WORLD):
        mine = json.loads(str(outs[r][f"s/mesh{i}"]))
        coord = np.argwhere(ids == r)[0]
        names = list(hm.mesh.axis_names)
        sl = tuple(slice(None) if a == "tp" else c
                   for a, c in zip(names, coord))
        assert mine["group_tp"] == [int(v) for v in ids[sl].reshape(-1)]
    if deg.get("ep", 1) == 1:
        jm = JaxLlama(JaxConfig.tiny(num_hidden_layers=1))
        want = {k: [list(e) if isinstance(e, tuple) else e for e in v]
                for k, v in japi.param_spec_tree(jm, hm).items()}
        assert got["specs"] == want


def test_communicate_topology_matches_jax():
    from paddle_tpu.distributed.topology import \
        CommunicateTopology as JaxTopo
    names = ["data", "pipe", "sharding", "sep", "model"]
    for dims in ([2, 1, 2, 1, 2], [1, 1, 4, 1, 2], [2, 2, 1, 2, 1]):
        a, b = CommunicateTopology(names, dims), JaxTopo(names, dims)
        assert a.world_size() == b.world_size()
        for n in names:
            assert a.get_comm_list(n) == b.get_comm_list(n)
            assert a.get_dim(n) == b.get_dim(n)
            for i in range(a.get_dim(n)):
                assert a.get_axis_list(n, i) == b.get_axis_list(n, i)
        for r in range(a.world_size()):
            assert a.get_coord(r) == b.get_coord(r)
            assert a.get_rank(**dict(zip(names, a.get_coord(r)))) == r


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}->{p[1]}")
def test_reshard_registry_matches_jax(ranks, pair):
    """reshard_with_registry over each registered pair (on the tp axis of
    a dp2 x tp2 mesh): rank r's local tensor equals device r's shard of
    JAX's result."""
    inp, outs = ranks
    hm = _jmesh(dp=2, tp=2)
    pl = {"R": japi.Replicate(), "P": japi.Partial(), "S0": japi.Shard(0),
          "S1": japi.Shard(1)}
    names = list(hm.mesh.axis_names)

    def placements(p):
        out = [japi.Replicate()] * len(names)
        out[names.index("tp")] = pl[p]
        return out
    res = jreshard(jnp.asarray(inp["xr"]), hm, placements(pair[0]),
                   placements(pair[1]))
    shards = _per_rank(res)
    for r in range(WORLD):
        np.testing.assert_allclose(outs[r][f"r/{pair[0]}->{pair[1]}"],
                                   shards[r], rtol=1e-6)


def test_pod_bootstrap_env_reads_torchrun_then_paddle(monkeypatch):
    """torchrun's MASTER_* / WORLD_SIZE / RANK / LOCAL_RANK first, then
    Paddle's PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID beside MASTER_*;
    fields are never mixed and a world of one needs no rendezvous."""
    from paddle_tpu_torch.parallel.mesh import pod_bootstrap_env
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "PADDLE_TRAINERS_NUM", "PADDLE_TRAINER_ID"):
        monkeypatch.delenv(k, raising=False)
    assert pod_bootstrap_env() is None
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert pod_bootstrap_env() is None
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    assert pod_bootstrap_env() == {"init_method": "tcp://10.0.0.1:29500",
                                   "world_size": 8, "rank": 3,
                                   "local_rank": 3}
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert pod_bootstrap_env() == {"init_method": "tcp://10.0.0.1:29500",
                                   "world_size": 4, "rank": 2,
                                   "local_rank": 1}
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert pod_bootstrap_env() is None


def test_pipeline_paths_raise_naming_a4b():
    """A.4b is ported: the paths it leaves for later (the launcher, the
    overlap / compat / rpc / auto-tuner / io / utils modules, the
    parallel scale and projection modules) raise naming A.4c where they
    are reached; PipelineParallel refuses a model that is no pipeline
    with TypeError, as JAX's does; PipelineOptimizer names its
    replacement."""
    from torch import nn
    import paddle_tpu_torch.incubate.optimizer as inc
    from paddle_tpu_torch import distributed, parallel
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineParallel
    for pkg, names in ((distributed, distributed.LATER),
                       (parallel, parallel.LATER)):
        for name in names:
            with pytest.raises(NotImplementedError, match="A.4c"):
                getattr(pkg, name)
    with pytest.raises(NotImplementedError, match="A.4c"):
        from paddle_tpu_torch.distributed import launch  # noqa: F401
    assert set(distributed.LATER) == {"launch", "overlap", "compat", "rpc",
                                      "auto_tuner", "io", "utils"}
    assert set(parallel.LATER) == {"scale", "projection"}
    with pytest.raises(TypeError, match="PipelineLayer"):
        PipelineParallel(nn.Linear(4, 4))
    with pytest.raises(AttributeError, match="parallel.schedules"):
        inc.PipelineOptimizer