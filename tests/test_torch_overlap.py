"""The port's comm/compute overlap (``paddle_tpu_torch.distributed.
overlap``): the strategy summary against the JAX package's and the fixed
policy's report, the overlapped tensor-parallel backward (dx's
all-reduce started before dW's product and waited after it) and the
gradient sums started from the backward's hooks, on 4 gloo ranks: each
overlapped step ("on") equals the serial reference's ("off",
``overlap.serial_reference``) bit for bit (each collective keeps its
tensor, size and group; only its start moves), under gradient
accumulation and recompute too, where each gradient's sum starts once,
on the last microbatch. The profiler-trace readers are held on
hand-built traces (a CPU trace has no kernels)."""

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import overlap as jov
from paddle_tpu.distributed.strategy import \
    DistributedStrategy as JaxStrategy
from paddle_tpu_torch.distributed import overlap
from paddle_tpu_torch.distributed.strategy import DistributedStrategy
from torch_dist_workers import run_ranks
from torch_mesh_refs import tiny_state, uneven_batch, worker_inputs

WORLD = 4
CASES = {
    "tp2dp2": {"mesh": {"dp": 2, "tp": 2}},
    "os_g": {"mesh": {"dp": 2, "fsdp": 2}, "level": "os_g"},
    "tp2dp2_accumulate_recompute": {"mesh": {"dp": 2, "tp": 2},
                                    "accumulate": 2,
                                    "cfg": {"recompute": "full"},
                                    "trace": True},
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    sd = tiny_state()
    inp = worker_inputs(sd, [uneven_batch(seed=i) for i in range(2)])
    scen = [{"fn": "overlap", "key": k,
             "args": {**a, "opt": "sgd", "steps": 2}}
            for k, a in CASES.items()]
    scen.append({"fn": "fleet_overlap", "key": "fleet"})
    scen.append({"fn": "mesh_check", "key": "mc", "args": {
        "layouts": ["dp2tp2", "fsdp4_os_g"], "preset": "tiny", "seq": 64}})
    return run_ranks(WORLD, scen, inp, tmp_path_factory.mktemp("overlap"))


# -- the policy ---------------------------------------------------------------

def _strategies():
    out = []
    for kind in ("default", "mp", "sharding", "extras_mp", "extras_comm"):
        pair = []
        for cls in (DistributedStrategy, JaxStrategy):
            st = cls()
            if kind == "mp":
                st.tensor_parallel.mp_async_allreduce = True
            elif kind == "sharding":
                st.sharding.comm_overlap = True
            elif kind == "extras_mp":
                st.extras["allreduce_matmul_grad_overlapping"] = True
            elif kind == "extras_comm":
                st.extras["comm_overlap"] = True
            pair.append(st)
        out.append(pytest.param(*pair, id=kind))
    return out


@pytest.mark.parametrize("mine,theirs", _strategies())
def test_strategy_summary_matches_jax(mine, theirs):
    assert overlap.strategy_overlap_summary(mine) == \
        jov.strategy_overlap_summary(theirs)


def test_enable_overlap_policy():
    """JAX's dict, reporting the fixed policy: both mechanisms on whatever
    a strategy asks; nothing turns them off; the serial reference is a
    scope, keyed in the fingerprint and left on exit."""
    r = overlap.enable_overlap(True)
    assert set(r) == {"enabled", "applied", "reason", "fingerprint"}
    assert r["enabled"] and r["applied"] == list(overlap.KNOBS)
    assert r["fingerprint"] == " ".join(overlap.KNOBS)
    with pytest.raises(ValueError, match="serial_reference"):
        overlap.enable_overlap(False)
    st = DistributedStrategy()
    st.tensor_parallel.mp_async_allreduce = True
    assert overlap.apply_strategy_overlap(st) == r
    assert overlap.apply_strategy_overlap(DistributedStrategy()) == r
    assert overlap.overlapped()
    with overlap.serial_reference():
        assert not overlap.overlapped()
        assert overlap.overlap_fingerprint() == "serial"
    assert overlap.overlapped()


@pytest.mark.parametrize("chunk", [False, True])
def test_copy_matmul_single_rank_equals_plain(chunk):
    """The overlapped Function at a group of one (no all-reduce) gives
    the plain product's output and gradients bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 12, generator=g)
    w = torch.randn(6 if chunk else 12, 7, generator=g)
    dy = torch.randn(2, 5, 7, generator=g)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    ya = overlap._CopyMatmul.apply(xa, wa, None, 2 if chunk else 1, 1,
                                   chunk)
    (ya * dy).sum().backward()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    yb = torch.matmul(xb.chunk(2, dim=-1)[1] if chunk else xb, wb)
    (yb * dy).sum().backward()
    for a, b in ((ya, yb), (xa.grad, xb.grad), (wa.grad, wb.grad)):
        assert torch.equal(a, b)


def test_fleet_init_installs_strategy_overlap(ranks):
    """After ``fleet.init``, with the strategy's overlap knobs on or
    none, a tensor-parallel product's backward overlaps dx's all-reduce
    and the report says so."""
    for o in ranks:
        assert o["fleet/on"].tolist() == [True, True]
        assert o["fleet/off"].tolist() == [True, True]


# -- on 4 gloo ranks ----------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_overlap_on_equals_off_bit_for_bit(ranks, case):
    for o in ranks:
        keys = [k for k in o if k.startswith(f"{case}/off/")
                and (k.endswith("losses") or "/param." in k)]
        assert len(keys) > 10
        for k in keys:
            on = o[k.replace("/off/", "/on/")]
            assert np.array_equal(on, o[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_each_gradient_sum_starts_once_a_step(ranks, case):
    """Overlapped, every parameter's sum started from its hook, once a
    step (under accumulation and recompute, once on the last
    microbatch); in the serial reference, none did."""
    for o in ranks:
        n = int(o[f"{case}/on/n_grads"])
        assert o[f"{case}/on/sync_issues"].tolist() == [n, n]
        assert o[f"{case}/off/sync_issues"].tolist() == [0, 0]


def test_grad_sums_start_on_last_microbatch_in_trace(ranks):
    """collectives_in_loop over the CPU profiler's trace of the
    accumulation step: no sum in the first microbatch, all in the
    last."""
    case = "tp2dp2_accumulate_recompute"
    for o in ranks:
        n = int(o[f"{case}/on/n_grads"])
        assert int(o[f"{case}/on/trace_total"]) == n
        assert o[f"{case}/on/trace_per_microbatch"].tolist() == [0, n]
        assert o[f"{case}/off/trace_per_microbatch"].tolist() == [0, 0]


@pytest.mark.parametrize("case", ["tp2dp2", "tp2dp2_accumulate_recompute"])
def test_dx_allreduce_issued_before_dw_and_waited_after(ranks, case):
    """The recorded events of every overlapped tensor-parallel backward:
    dx's all-reduce issued, then dW's product, then the wait on its
    work handle."""
    for o in ranks:
        order = o[f"{case}/order"]
        calls = sorted(set(order[:, 1].tolist()))
        # qkv and gate/up of each of the tiny model's layers, a step
        assert len(calls) >= 4
        for c in calls:
            assert order[order[:, 1] == c, 0].tolist() == [0, 1, 2], c


def test_mesh_check_overlap_both(ranks):
    """``tools.mesh_check``'s check on the CPU: each layout within 1e-4
    of one rank's step, and its overlapped step equal to its serial
    one."""
    import json
    lines = json.loads(str(ranks[0]["mc/results"]))
    assert [x["layout"] for x in lines] == ["dp2tp2", "fsdp4_os_g"]
    assert all(x["ok"] and x["overlap_equal"] for x in lines), lines


def test_os_g_records_no_tensor_parallel_events(ranks):
    for o in ranks:
        assert o["os_g/order"].size == 0


# -- reading a profiler trace (hand-built, as on the card) --------------------

def _k(name, ts, dur, stream, corr=None):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream, "correlation": corr}}


def _trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": overlap.DX_SPAN,
         "ts": 100, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "ts": 102, "dur": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "user_annotation", "name": overlap.DX_SPAN,
         "ts": 300, "dur": 5, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 301, "dur": 1, "tid": 1, "args": {"correlation": 9}},
        _k("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 110, 40, 20, 7),
        _k("sm90_xmma_gemm_bf16bf16_bf16f32", 120, 50, 7, 8),
        _k("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 310, 30, 20, 9),
        _k("rms_norm_bwd_kernel", 330, 20, 7, 10),
    ]
    return {"traceEvents": ev}


def test_backward_overlap_independent_reads_trace():
    r = overlap.backward_overlap_independent(_trace())
    assert r == {"allreduces": 2, "overlapping_gemm": 1,
                 "each": [True, False]}


def test_exposed_comm_reads_trace(tmp_path):
    import json
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_trace()))
    r = overlap.exposed_comm(str(path))
    # the first all-reduce's 40 us: 10 before the GEMM; the second's 30:
    # 20 before the norm kernel
    assert r["nccl_kernels"] == 2
    assert r["nccl_ms"] == pytest.approx(0.070)
    assert r["exposed_ms"] == pytest.approx(0.030)
    assert r["compute_ms"] == pytest.approx(0.070)
