"""Rank workers of the multi-rank CPU tests (gloo, one process per rank).

:func:`run_ranks` starts ``world`` processes of this module (``python
torch_dist_workers.py``), each joining a gloo group on a ``file://``
store under the test's tmp directory, so concurrent test workers never
race for a port. The parent writes the inputs as one ``.npz``; each rank
runs the listed scenarios in order and writes ``rank<r>.npz`` with each
scenario's outputs under ``<key>/<name>``. This module imports only
numpy, torch and paddle_tpu_torch: the JAX references run in the parent.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
from typing import Dict, List

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240


def run_ranks(world: int, scenarios: List[dict], inputs: Dict[str, np.ndarray],
              tmp, during=None,
              launcher: bool = False) -> List[Dict[str, np.ndarray]]:
    """Run ``scenarios`` ([{"fn", "key", "args"}]) on ``world`` gloo
    ranks; returns each rank's outputs. ``during()`` (the parent's JAX
    references, say) runs while the ranks do. ``launcher``: the port's
    launcher (``python -m paddle_tpu_torch.distributed.launch``) starts
    the ranks, which join through its environment (a TCP store on rank
    0), and their output is in ``tmp/log``."""
    tmp = pathlib.Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "scenarios.json").write_text(json.dumps(scenarios))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    if launcher:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nproc_per_node", str(world), "--log_dir", str(tmp / "log"),
             str(pathlib.Path(__file__)), str(tmp), "env"], env=env,
            cwd=str(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)]
    else:
        procs = [subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__)), str(tmp), str(r),
             str(world)], env=env, cwd=str(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        if during is not None:
            during()
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad and launcher:
        logs = [(tmp / "log" / f"workerlog.{r}").read_text()
                for r in range(world)]
        bad = [(r, procs[0].returncode) for r in range(world)]
    if bad:
        raise AssertionError(f"ranks failed {bad}:\n" + "\n".join(
            f"--- rank {r}\n{logs[r][-4000:]}" for r, _ in bad))
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


# -- helpers the scenarios share ------------------------------------------------

def _t(a, dtype=None):
    import torch
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().float().cpu().numpy()


def _mesh(args):
    from paddle_tpu_torch.parallel.mesh import HybridMesh
    return HybridMesh.build(devices="cpu", **args.get("mesh", {}))


def _model(inp, args):
    """The port's tiny Llama (``args["family"]`` "moe": MoE LM) of
    ``args["cfg"]`` on the CPU with the parent's (JAX's) weights."""
    from paddle_tpu_torch.convert import state_dict_from_jax
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM
    moe = args.get("family") == "moe"
    cfg = (MoEConfig if moe else LlamaConfig).tiny(**args.get("cfg", {}))
    pre = args.get("sd", "sd") + "/"
    sd = {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}
    m = (MoEForCausalLM if moe else LlamaForCausalLM)(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(sd, cfg, device="cpu"))
    return m


def _batch(inp, prefix="batch/"):
    return {k[len(prefix):]: _t(v) for k, v in inp.items()
            if k.startswith(prefix)}


def _optimizer(args, model):
    from paddle_tpu_torch.optimizer import SGD, AdamW, ClipGradByGlobalNorm
    clip = ClipGradByGlobalNorm(args.get("clip", 1.0))
    if args.get("opt", "adamw") == "sgd":
        return SGD(learning_rate=args.get("lr", 0.1), parameters=model,
                   grad_clip=clip)
    return AdamW(learning_rate=args.get("lr", 1e-3), parameters=model,
                 weight_decay=0.01, grad_clip=clip)


def _full_grads(model, names=None) -> Dict[str, np.ndarray]:
    """Every synced gradient whole (FSDP2 shards gathered, then the
    tensor, expert and stage shards), as full_state_dict gathers the
    parameters; ``names`` renames them."""
    from paddle_tpu_torch.parallel.api import full_state_dict
    return {"grad." + (names or {}).get(n, n): _np(g)
            for n, g in full_state_dict(model, grads=True).items()}


# -- scenarios ------------------------------------------------------------------

def sc_train(inp, args):
    """One Trainer step of the tiny Llama sharded as ``args`` says (mesh
    degrees; "level": a group_sharded_parallel level; "fleet": the fleet
    facade with those degrees): the loss, the synced global gradients
    (``grads``), the global gradient norm, and every parameter after the
    step, whole."""
    import torch
    from paddle_tpu_torch.parallel.api import (full_state_dict, mesh_plan_of,
                                               shard_layer)
    from paddle_tpu_torch.trainer import Trainer
    model = _model(inp, args)
    if args.get("fleet"):
        from paddle_tpu_torch.distributed import fleet
        st = fleet.DistributedStrategy()
        st.hybrid_configs = args["fleet"]
        if args.get("sp_mode"):
            st.extras["sp_mode"] = args["sp_mode"]
        fleet.init(is_collective=True, strategy=st, devices="cpu")
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(_optimizer(args, model))
        assert fleet.worker_num() == torch.distributed.get_world_size()
        hcg = fleet.get_hybrid_communicate_group()
        assert hcg.get_model_parallel_world_size() == \
            args["fleet"].get("mp_degree", 1)
    else:
        hm = _mesh(args)
        hm.__enter__()
        shard_layer(model, hm)
        opt = _optimizer(args, model)
        if args.get("level"):
            from paddle_tpu_torch.distributed.sharding import (
                group_sharded_parallel)
            model, opt, _ = group_sharded_parallel(model, opt,
                                                   level=args["level"])
    A = args.get("accumulate", 1)
    tr = Trainer(model, opt, offload_opt_state=args.get("offload"),
                 accumulate_steps=A)
    plan = mesh_plan_of(model)
    out = {}
    if args.get("grads", True) and plan.level != "os_g":
        # the synced gradients and their global norm, before any update
        batch = plan.local_batch(_batch(inp, args.get("batch", "batch/")))
        model.zero_grad(set_to_none=True)
        loss = model(**batch, return_logits=False)
        loss.backward()
        plan.sync_grads(tr.params)
        _, gv = plan.opt_views(tr.params)
        out["gnorm"] = np.asarray(float(torch.sqrt(plan.global_sq(gv))))
        out.update(_full_grads(model))
        out["loss0"] = np.asarray(float(loss))
    model.zero_grad(set_to_none=True)
    losses, issues = [], []
    for i in range(args.get("steps", 1)):
        batch = _batch(inp, args.get("batch", f"batch{i}/"))
        if A > 1:
            batch = {k: v.reshape(A, -1, *v.shape[1:])
                     for k, v in batch.items()}
        n0 = plan.sync_issues
        if args.get("trace") and i == 0:
            # the first step under torch.profiler: its chrome trace
            from paddle_tpu_torch.distributed.overlap import \
                collectives_in_loop
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                losses.append(float(tr.train_step(batch)))
            path = f"trace{torch.distributed.get_rank()}.json"
            prof.export_chrome_trace(path)
            total, per = collectives_in_loop(path)
            out["trace_total"] = np.asarray(total)
            out["trace_per_microbatch"] = np.asarray(per)
        else:
            losses.append(float(tr.train_step(batch)))
        issues.append(plan.sync_issues - n0)
    out["losses"] = np.asarray(losses)
    out["sync_issues"] = np.asarray(issues)
    out["n_grads"] = np.asarray(sum(p.grad is not None
                                    for p in tr.params.values()))
    for k, v in full_state_dict(model).items():
        out["param." + k] = _np(v)
    if args.get("fleet"):
        from paddle_tpu_torch.distributed import fleet
        fleet.stop()
    else:
        hm.__exit__(None, None, None)
    return out


def sc_shards(inp, args):
    """This rank's tensor-parallel shards of the tiny Llama and the whole
    state gathered back (``full_state_dict``)."""
    import torch
    from paddle_tpu_torch.parallel.api import (full_state_dict, shard_layer,
                                               shard_optimizer_state)
    model = _model(inp, args)
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    hm = _mesh(args)
    shard_layer(model, hm)
    out = {"local." + n: _np(p) for n, p in model.named_parameters()}
    # a full optimizer state (each slot a copy of its parameter) is cut
    # as the parameters are
    st = shard_optimizer_state({"step": 1, "master": {}, "slots": {
        n: {"m": t} for n, t in full.items()}}, model)
    out["opt_state_like_params"] = np.asarray(all(
        torch.equal(st["slots"][n]["m"], p.detach())
        for n, p in model.named_parameters()))
    out.update({"full." + k: _np(v)
                for k, v in full_state_dict(model).items()})
    return out


def sc_specs(inp, args):
    """param_spec_tree of the tiny Llama on each mesh of ``args["meshes"]``
    (JSON text), and HybridMesh / HCG / topology answers."""
    from paddle_tpu_torch.distributed.topology import HybridCommunicateGroup
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.parallel.api import param_spec_tree
    from paddle_tpu_torch.parallel.mesh import HybridMesh
    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    out = {}
    for i, deg in enumerate(args["meshes"]):
        hm = HybridMesh.build(devices="cpu", **deg)
        hcg = HybridCommunicateGroup(hm)
        topo = hcg.topology()
        ans = {"axes": list(hm.axes), "shape": [hm.shape[a] for a in hm.axes],
               "dp": hcg.get_data_parallel_world_size(),
               "mp": hcg.get_model_parallel_world_size(),
               "pp": hcg.get_pipe_parallel_world_size(),
               "sharding": hcg.get_sharding_parallel_world_size(),
               "sep": hcg.get_sep_parallel_world_size(),
               "ep": hm.get_expert_parallel_world_size(),
               "nproc": hm.nproc,
               "topo_dims": [topo.get_dim(n) for n in
                             topo.get_hybrid_group_names()],
               "comm_model": topo.get_comm_list("model"),
               "comm_data": topo.get_comm_list("data"),
               "group_tp": hm.group_ranks("tp"),
               "group_data": hm.group_ranks(("dp", "fsdp")),
               "specs": {} if deg.get("ep", 1) > 1 else {
                   k: [list(e) if isinstance(e, tuple) else e for e in v]
                   for k, v in param_spec_tree(model, hm).items()}}
        out[f"mesh{i}"] = np.asarray(json.dumps(ans))
    return out


def sc_collectives(inp, args):
    """Every collective of ``communication`` on this rank's slice of the
    rank-major inputs (a mesh of one dp axis over the world)."""
    import torch
    from paddle_tpu_torch.distributed import communication as c
    hm = _mesh(args)
    r, n = hm.rank, hm.nproc
    g = c.Group("dp", hm)
    x = _t(inp["x"][r])
    out = {}
    for op in ("sum", "max", "min", "avg"):
        out["all_reduce_" + op] = _np(c.all_reduce(x.clone(), op, g))
    out["all_gather"] = _np(torch.stack(c.all_gather(None, x, g)))
    out["reduce_scatter"] = _np(c.reduce_scatter(None, x.clone(), group=g))
    out["alltoall"] = _np(torch.cat(c.alltoall(x.clone(), group=g)))
    out["broadcast"] = _np(c.broadcast(x.clone(), src=1, group=g))
    out["reduce"] = _np(c.reduce(x.clone(), dst=2, group=g))
    payload = _t(inp["payload"][r])
    out["scatter"] = _np(c.scatter(torch.empty_like(payload[0]), payload,
                                   src=1, group=g))
    got = c.gather(x.clone(), dst=0, group=g)
    out["gather"] = _np(torch.stack(got)) if r == 0 else np.zeros(0)
    out["send_to"] = _np(c.send_to(x.clone(), dst=3, src=1, group=g))
    out["ppermute_ring"] = _np(c.ppermute(
        x, [(i, (i + 1) % n) for i in range(n)], g))
    out["ppermute_pairs"] = _np(c.ppermute(x, [(0, 2), (2, 0)], g))
    out["send_recv"] = _np(c.send_recv(x, 1, g))
    # P2P through Paddle's batch_isend_irecv with P2POps
    recv = torch.empty_like(x)
    ws = c.batch_isend_irecv([
        c.P2POp(torch.distributed.isend, x.clone(), g.ranks[(r + 1) % n]),
        c.P2POp(torch.distributed.irecv, recv, g.ranks[(r - 1) % n])])
    for w in ws:
        w.wait()
    out["batch_isend_irecv"] = _np(recv)
    # the differentiable forms: values and gradients of sum(w * f(x))
    w = _t(inp["w"][r])
    for name, fn in (("copy", lambda t: c.copy_to_group(t, g)),
                     ("reduce", lambda t: c.reduce_from_group(t, g)),
                     ("gather", lambda t: c.gather_from_group(t, g, 0)),
                     ("scatter", lambda t: c.scatter_to_group(t, g, 0)),
                     ("rs", lambda t: c.reduce_scatter_to_group(t, g, 0)),
                     ("a2a", lambda t: c.all_to_all(t, g, 0, 0)),
                     ("shift", lambda t: c.ring_shift(t, g, 1))):
        xi = x.clone().requires_grad_(True)
        y = fn(xi)
        ww = w[:y.shape[0]] if y.shape[0] <= w.shape[0] else w.repeat(
            y.shape[0] // w.shape[0], 1)
        (y * ww).sum().backward()
        out[f"diff_{name}_y"] = _np(y)
        out[f"diff_{name}_g"] = _np(xi.grad)
    return out


def sc_reshard(inp, args):
    """reshard_with_registry over every registered pair on a dp x tp mesh
    (the pairs act over tp): this rank's local result."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from paddle_tpu_torch.parallel.reshard import reshard_with_registry
    hm = _mesh(args)
    x = _t(inp["xr"])
    names = {"R": Replicate(), "P": Partial(), "S0": Shard(0),
             "S1": Shard(1)}
    out = {}
    for src, dst in args["pairs"]:
        sp = [Replicate()] * len(hm.axes)
        dp_ = list(sp)
        sp[hm.axes.index("tp")] = names[src]
        dp_[hm.axes.index("tp")] = names[dst]
        local = x
        if src.startswith("S"):
            local = x.chunk(hm.axis_size("tp"), dim=int(src[1]))[
                hm.coordinate("tp")].contiguous()
        out[f"{src}->{dst}"] = _np(reshard_with_registry(local, hm, sp, dp_))
    return out


def sc_tp_layers(inp, args):
    """Column/Row/VocabParallel layers at this tp: output and the full
    input gradient; weight gradients gathered whole."""
    import torch
    from paddle_tpu_torch.distributed import communication as c
    from paddle_tpu_torch.parallel import mp_layers as mp
    hm = _mesh(args)
    tp = c.Group("tp", hm)
    x = _t(inp["x"])
    out = {}
    col = mp.ColumnParallelLinear(16, 24, has_bias=True, mesh=hm)
    col.load_full(_t(inp["w_col"]), _t(inp["b_col"]))
    row = mp.RowParallelLinear(24, 8, has_bias=True, mesh=hm)
    row.load_full(_t(inp["w_row"]), _t(inp["b_row"]))
    xi = x.clone().requires_grad_(True)
    y = row(col(xi))
    (y * _t(inp["dy"])).sum().backward()
    out["mlp_y"] = _np(y)
    out["mlp_dx"] = _np(xi.grad)
    out["w_col_grad"] = _np(torch.cat(c.all_gather(None, col.weight.grad,
                                                   tp), 1))
    out["w_row_grad"] = _np(torch.cat(c.all_gather(None, row.weight.grad,
                                                   tp), 0))
    out["b_row_grad"] = _np(row.bias.grad)
    gat = mp.ColumnParallelLinear(16, 24, has_bias=False,
                                  gather_output=True, mesh=hm)
    gat.load_full(_t(inp["w_col"]))
    out["gathered"] = _np(gat(x))
    emb = mp.VocabParallelEmbedding(32, 16, mesh=hm)
    emb.load_full(_t(inp["table"]))
    e = emb(_t(inp["ids"]))
    (e * _t(inp["de"])).sum().backward()
    out["emb"] = _np(e)
    out["emb_grad"] = _np(torch.cat(c.all_gather(None, emb.weight.grad, tp)))
    # the vocab-parallel CEs over this rank's vocabulary shard
    logits = _t(inp["logits"])
    lab = _t(inp["labels"])
    r, n = hm.coordinate("tp"), hm.axis_size("tp")
    ll = logits.chunk(n, -1)[r].clone().requires_grad_(True)
    nll = mp.parallel_cross_entropy(ll, lab, mesh=hm)
    nll.sum().backward()
    out["pce"] = _np(nll)
    out["pce_grad"] = _np(torch.cat(c.all_gather(None, ll.grad, tp), -1))
    h = _t(inp["h"]).requires_grad_(True)
    wv = _t(inp["wv"]).chunk(n, -1)[r].clone().requires_grad_(True)
    nll = mp.parallel_fused_linear_cross_entropy(h, wv, lab, mesh=hm)
    nll.sum().backward()
    out["pfce"] = _np(nll)
    out["pfce_dh"] = _np(h.grad)
    out["pfce_dw"] = _np(torch.cat(c.all_gather(None, wv.grad, tp), -1))
    return out


def sc_sp_attention(inp, args):
    """ring_attention or ulysses_attention on this rank's sequence block:
    the output and the q/k/v gradients of sum(out * dout), every rank's
    block gathered."""
    import torch
    from paddle_tpu_torch.distributed import communication as c
    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    from paddle_tpu_torch.parallel.ulysses import ulysses_attention
    hm = _mesh(args)
    sep = c.Group("sep", hm)
    n, r = hm.axis_size("sep"), hm.coordinate("sep")

    def mine(a):
        return _t(a).chunk(n, dim=1)[r].contiguous()
    out = {}
    for case in args["cases"]:
        q, k, v = (mine(inp[t]).requires_grad_(True) for t in "qkv")
        seg = mine(inp["seg"]) if case.get("seg") else None
        if case["fn"] == "ring":
            o = ring_attention(q, k, v, causal=case["causal"], mesh=hm,
                               segment_ids=seg)
        else:
            o = ulysses_attention(q, k, v, causal=case["causal"], mesh=hm)
        (o * mine(inp["dout"])).sum().backward()
        key = case["key"]
        for name, t in (("out", o), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            out[f"{key}.{name}"] = _np(torch.cat(c.all_gather(
                None, t.detach().contiguous(), sep), dim=1))
    return out


def sc_sharded_save(inp, args):
    """A sharded state saves through the plan-aware sharded save: FSDP2
    parameters through ``save_state_dict(layout=)``, read back whole
    equal to ``full_state_dict``; a Trainer with a checkpoint manager on
    the mesh (a committed step whose recorded plan has the mesh's axes,
    restored into the live state); and ``save_group_sharded_model``,
    read back into this rank's slices. Each leg's error ("no error" when
    it works), and whether each check held."""
    import torch
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.parallel.api import _local, full_state_dict
    from paddle_tpu_torch.resilience import CheckpointManager, read_plan
    from paddle_tpu_torch.trainer import Trainer
    model = _model(inp, args)
    hm = _mesh(args)
    cwd = os.getcwd()
    with hm:
        model, opt, _ = group_sharded_parallel(model, _optimizer(args, model))
        full = full_state_dict(model)
        msgs, checks = [], []

        def save_params():
            path = os.path.join(cwd, "ck")
            checkpoint.save_state_dict(dict(model.named_parameters()), path,
                                       layout=model)
            back = checkpoint.load_flat(path)
            checks.append(all(torch.equal(back[k], v)
                              for k, v in full.items()))

        def fit_and_restore():
            mgr = CheckpointManager(os.path.join(cwd, "mgr"))
            tr = Trainer(model, opt)
            tr.fit([_batch(inp)], 1, checkpoint_manager=mgr)
            plan = read_plan(mgr.step_dir(1))
            checks.append(mgr.committed_steps() == [1]
                          and plan.axes["fsdp"] == 4)
            step, tree = mgr.restore(tr._ckpt_tree())
            checks.append(step == 1 and all(
                torch.equal(_local(p).detach(), tree["params"][n])
                for n, p in tr.params.items()))
            mgr.close()

        def group_sharded():
            path = os.path.join(cwd, "gs")
            save_group_sharded_model(model, path, opt)
            like = {"params": dict(model.named_parameters()),
                    "opt_state": {"master": opt._state["master"],
                                  "slots": opt._state["slots"]}}
            back = checkpoint.load_state_dict(path, like, mesh=model)
            checks.append(all(
                torch.equal(back["params"][n], _local(p).detach())
                for n, p in model.named_parameters()))
        for fn in (save_params, fit_and_restore, group_sharded):
            try:
                fn()
                msgs.append("no error")
            except Exception as e:  # noqa: BLE001 — reported to the test
                msgs.append(f"{type(e).__name__}: {e}")
    return {"msgs": np.asarray(json.dumps(msgs)),
            "checks": np.asarray(json.dumps(checks))}


def sc_refused(inp, args):
    """A model without a sharding table or a global-mean loss (a bare
    Linear) through ``shard_layer`` on ``args``'s mesh,
    ``group_sharded_parallel`` and ``fleet.distributed_model`` at dp 2 x
    mp 2, and the tiny MoE LM (which has both) through ``shard_layer``
    and ``fleet.distributed_model``: each error message ("no error" when
    taken), and whether tp cut the MoE's attention."""
    from torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel.api import shard_layer

    def attempt(fn):
        try:
            fn()
            return "no error"
        except NotImplementedError as e:
            return str(e)
    moe = MoEForCausalLM(MoEConfig.tiny(), device="cpu")
    moe2 = MoEForCausalLM(MoEConfig.tiny(), device="cpu")
    qkv = "layers.0.self_attn.qkv_proj"
    shape = tuple(moe.get_parameter(qkv).shape)
    lin = nn.Linear(4, 4)
    msgs = []
    hm = _mesh(args)
    with hm:
        msgs.append(attempt(lambda: shard_layer(lin, hm)))
        msgs.append(attempt(lambda: group_sharded_parallel(
            lin, SGD(learning_rate=0.1, parameters=lin), level="os_g")))
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=st, devices="cpu")
    msgs.append(attempt(lambda: fleet.distributed_model(lin)))
    fleet.stop()
    with hm:
        msgs.append(attempt(lambda: shard_layer(moe, hm)))
    fleet.init(is_collective=True, strategy=st, devices="cpu")
    msgs.append(attempt(lambda: fleet.distributed_model(moe2)))
    fleet.stop()
    cut = all(tuple(m.get_parameter(qkv).shape) == (shape[0], shape[1] // 2)
              for m in (moe, moe2))
    return {"msgs": np.asarray(json.dumps(msgs)),
            "moe_cut": np.asarray(cut)}


def sc_pipe_train(inp, args):
    """The tiny Llama (JAX's weights) as ``LlamaForCausalLMPipe`` on
    ``args["mesh"]`` (pp stages, ``args["sched"]``, 2 microbatches a
    data rank): with ``wrapper``, PipelineParallel.train_batch steps;
    otherwise the fused step's synced gradients, their global norm and
    the stages' peak held microbatches, then Trainer steps. Outputs under
    the unpipelined model's names, gathered whole."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaForCausalLMPipe, pipe_name
    from paddle_tpu_torch.parallel.api import (full_state_dict, mesh_plan_of,
                                               shard_layer)
    from paddle_tpu_torch.trainer import Trainer
    base = _model(inp, args)
    names = {pipe_name(n): n for n in base.state_dict()}
    hm = _mesh(args)
    out = {}
    with hm:
        pipe = LlamaForCausalLMPipe(
            base.cfg, num_stages=hm.axis_size("pp"),
            num_microbatches=args.get("micro", 2),
            pp_schedule=args.get("sched", "1f1b"), device="cpu")
        pipe.load_from_unpipelined(base)
        shard_layer(pipe, hm)
        opt = _optimizer(args, pipe)
        plan = mesh_plan_of(pipe)
        steps = args.get("steps", 1)
        if args.get("wrapper"):
            from paddle_tpu_torch.distributed.fleet.meta_parallel import \
                PipelineParallel
            pp = PipelineParallel(pipe)
            losses = []
            for i in range(steps):
                b = _batch(inp, f"batch{i}/")
                losses.append(float(pp.train_batch(
                    (b["input_ids"], b["labels"]), opt)))
            ev = pp.eval_batch((b["input_ids"], b["labels"]),
                               compute_loss=True)
            out["eval_loss"] = np.asarray(float(ev))
        else:
            loss, _ = pipe.loss_and_grads(**plan.local_batch(_batch(inp)))
            params = dict(pipe.named_parameters())
            plan.sync_grads(params)
            _, gv = plan.opt_views(params)
            out["gnorm"] = np.asarray(float(torch.sqrt(plan.global_sq(gv))))
            out.update(_full_grads(pipe, names))
            out["loss0"] = np.asarray(float(loss))
            out["peak_live"] = np.asarray(pipe.pipe_stats["peak_live"])
            pipe.zero_grad(set_to_none=True)
            tr = Trainer(pipe, opt)
            losses = [float(tr.train_step(_batch(inp, f"batch{i}/")))
                      for i in range(steps)]
        out["losses"] = np.asarray(losses)
        for k, v in full_state_dict(pipe).items():
            out["param." + names[k]] = _np(v)
    return out


def sc_moe_layer(inp, args):
    """One MoELayer (JAX's weights, ``args["cf"]``; None: dropless) on
    ``args["mesh"]``: this rank's block of the global tokens, the loss
    sum(out * dout) + aux backward, the gradients synced; the outputs,
    input gradients, aux and gradients gathered whole; ``args["x"]``
    names the input (default ``moe_x``). On a mesh with ep, rank 0 also
    runs the layer over ``ep`` virtual ranks (``forward_virtual_ep``) on
    its ep group's tokens."""
    import torch
    from paddle_tpu_torch.distributed import communication as c
    from paddle_tpu_torch.parallel.api import full_state_dict, shard_layer
    from paddle_tpu_torch.parallel.moe import EP_HOST_READS, MoELayer
    hm = _mesh(args)
    cf = args.get("cf")
    x, dout = _t(inp[args.get("x", "moe_x")]), _t(inp["moe_dout"])
    e, d = inp["moe/gate_weight"].shape[1], x.shape[-1]
    f = inp["moe/experts.w_down"].shape[1]

    def layer():
        lay = MoELayer(d, f, e, top_k=2, capacity_factor=cf, device="cpu")
        lay.load_state_dict({k[4:]: _t(v) for k, v in inp.items()
                             if k.startswith("moe/")})
        return lay
    out = {}
    n, r = hm.group_size(("dp", "ep")), hm.group_rank(("dp", "ep"))
    ep = hm.axis_size("ep")
    if hm.rank == 0 and ep > 1:
        # the ep group of rank 0 holds the first ep blocks of tokens
        virt = layer()
        xs = [t.clone().requires_grad_(True) for t in x.chunk(n)[:ep]]
        outs, aux = virt.forward_virtual_ep(xs, ep)
        (sum((o * g).sum() for o, g in zip(outs, dout.chunk(n)))
         + aux).backward()
        out["virtual_out"] = _np(torch.cat(outs))
        out["virtual_aux"] = np.asarray(float(aux))
        out["virtual_dx"] = _np(torch.cat([t.grad for t in xs]))
    lay = layer()
    lay._sharding_annotations = {
        "experts.w_gate_up": ((("ep", "dp", "fsdp"), None, "tp"),
                              [(f, 1), (f, 1)]),
        "experts.w_down": ((("ep", "dp", "fsdp"), "tp", None), None)}
    lay._global_mean_loss = True
    with hm:
        shard_layer(lay, hm)
        reads = EP_HOST_READS[0]
        xl = x.chunk(n)[r].clone().requires_grad_(True)
        o, aux = lay(xl)
        ((o * dout.chunk(n)[r]).sum() + aux).backward()
        out["host_reads"] = np.asarray(EP_HOST_READS[0] - reads)
        lay._mesh_plan.sync_grads(dict(lay.named_parameters()))
        data = c.Group(("dp", "ep"), hm)
        out["out"] = _np(torch.cat(c.all_gather(None, o.detach(), data)))
        out["dx"] = _np(torch.cat(c.all_gather(None, xl.grad, data)))
        out["aux"] = np.asarray(float(aux))
        out.update(_full_grads(lay))
    return out


def sc_overlap(inp, args):
    """:func:`sc_train` (no gradient probe) in the serial schedule
    (``distributed.overlap.serial_reference``), then as the port runs
    it, overlapped: each run's outputs under "off/" and "on/", and the
    overlapped run's order of the tensor-parallel backward's events
    (issue, dw, wait) as rows of (kind, call)."""
    import contextlib
    from paddle_tpu_torch.distributed import overlap
    out = {}
    kinds = {"issue": 0, "dw": 1, "wait": 2}
    for tag in ("off", "on"):
        scope = (overlap.serial_reference() if tag == "off"
                 else contextlib.nullcontext())
        with scope, overlap.record_order() as ev:
            res = sc_train(inp, {**args, "grads": False})
        out.update({f"{tag}/{k}": v for k, v in res.items()})
        if tag == "on":
            out["order"] = np.asarray([(kinds[k], i) for k, i in ev],
                                      dtype=np.int64).reshape(-1, 2)
    return out


def sc_fleet_overlap(inp, args):
    """``fleet.init`` with the strategy's overlap knobs on, then with
    none: after each, whether a tensor-parallel product's backward
    overlapped dx's all-reduce (its events recorded) and whether
    ``apply_strategy_overlap`` reports the overlap enabled."""
    import torch
    from paddle_tpu_torch.distributed import fleet, overlap
    from paddle_tpu_torch.distributed.communication import Group
    from paddle_tpu_torch.parallel.mesh import current_mesh
    out = {}
    for tag, on in (("on", True), ("off", False)):
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
        st.tensor_parallel.mp_async_allreduce = on
        st.sharding.comm_overlap = on
        fleet.init(is_collective=True, strategy=st, devices="cpu")
        x = torch.ones(2, 4, requires_grad=True)
        w = torch.ones(4, 3, requires_grad=True)
        with overlap.record_order() as ev:
            overlap.copy_matmul(x, w, Group("tp", current_mesh())).sum(
                ).backward()
        out[tag] = np.asarray([[k for k, _ in ev] == ["issue", "dw", "wait"],
                               overlap.apply_strategy_overlap(st)["enabled"]])
        fleet.stop()
    return out


def sc_mesh_check(inp, args):
    """``tools.mesh_check.run`` on this rank: its results as JSON text."""
    import torch
    from paddle_tpu_torch.tools.mesh_check import run
    return {"results": np.asarray(json.dumps(run(
        args["layouts"], args["preset"], args["seq"], torch.device("cpu"))))}


def sc_mesh_generate(inp, args):
    """``tools.mesh_check.run_generate`` on this rank (the tiny Llama):
    its results as JSON text."""
    import torch
    from paddle_tpu_torch.tools.mesh_check import run_generate
    return {"results": np.asarray(json.dumps(run_generate(
        args["legs"], torch.device("cpu"))))}


# -- rpc: what a spawned process calls (this module imports no JAX) -----------

def rpc_add(a, b):
    return a + b


def rpc_boom():
    raise ValueError("remote failure")


def rpc_child(master_port, q):
    """Worker "w1" of a 2-process rpc job: calls back into "w0"."""
    from paddle_tpu_torch.distributed import rpc
    rpc.init_rpc("w1", rank=1, world_size=2,
                 master_endpoint=f"127.0.0.1:{master_port}")
    q.put(rpc.rpc_sync("w0", rpc_add, args=(7, 8)))
    rpc.shutdown()


# -- compat.spawn: what each spawned rank runs --------------------------------

def compat_rank(out_dir):
    """One rank of a 2-process ``compat.spawn`` job (gloo through the
    environment spawn sets): the object collectives, point to point, an
    uneven ``alltoall_single``, the env and backend queries. Writes its
    results as JSON to ``out_dir/rank<r>.json``."""
    import torch
    from paddle_tpu_torch.distributed import compat
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    init_parallel_env(dp=2, backend="gloo", device="cpu")
    r = torch.distributed.get_rank()
    out = {"initialized": compat.is_initialized(),
           "backend": compat.get_backend(), "env_rank":
           compat.ParallelEnv().rank, "env_world": compat.ParallelEnv().nranks}
    gathered = []
    compat.all_gather_object(gathered, {"rank": r, "sq": r * r})
    out["gathered"] = gathered
    objs = [f"from{r}", r] if r == 1 else [None, None]
    compat.broadcast_object_list(objs, src=1)
    out["broadcast"] = objs
    mine = []
    compat.scatter_object_list(mine, [["a"], ["b"]] if r == 0 else None)
    out["scattered"] = mine
    t = torch.full((3,), float(r + 1))
    if r == 0:
        compat.send(t, dst=1)
    else:
        compat.recv(t, src=0)
    out["p2p"] = t.tolist()
    # rank r sends rows [0, 1 + r) to rank 0 and the rest to rank 1
    x = torch.arange(4, dtype=torch.float32) + 10 * r
    ins = [1 + r, 3 - r]
    outs = [[1, 2], [3, 2]][r]
    y = compat.alltoall_single(x, in_split_sizes=ins, out_split_sizes=outs)
    out["alltoall"] = y.tolist()
    compat.gloo_barrier()
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    compat.destroy_process_group()


def sc_plan_state(inp, args):
    """The tiny Llama (the parent's weights) under ``args["config"]``'s
    ShardingPlan through ``Trainer.apply_plan`` (or, with "level", under
    ``shard_layer`` and ``group_sharded_parallel`` at that level on
    ``args["mesh"]``), ``args["steps"]`` AdamW steps on the batch, then:
    "restore" — the newest good step of that root restored (resharded
    when its plan differs) into the live state, and whether every local
    parameter and slot equals ``shard_layer``'s cut of the checkpoint's
    whole state; "save" — the state saved at each of ``save_steps``
    under a CheckpointManager on the mesh; "loader" — whether
    ``DataLoader(sharding=)`` with the plan and with the MeshPlan yields
    ``MeshPlan.local_batch``; "losses" — the losses of 2 more steps."""
    import torch
    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.distributed.auto_parallel import (
        ParallelConfig, plan_for_config)
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.parallel.api import (_local, _param_local,
                                               mesh_plan_of, shard_layer)
    from paddle_tpu_torch.resilience import CheckpointManager
    from paddle_tpu_torch.trainer import Trainer
    model = _model(inp, args)
    cfg = LlamaConfig.tiny(**args.get("cfg", {}))
    opt = _optimizer(args, model)
    if args.get("level"):
        from paddle_tpu_torch.distributed.sharding import \
            group_sharded_parallel
        hm = _mesh(args)
        hm.__enter__()
        shard_layer(model, hm)
        model, opt, _ = group_sharded_parallel(model, opt,
                                               level=args["level"])
        tr = Trainer(model, opt)
        plan = tr._mesh_sharding_plan()
    else:
        plan = plan_for_config(cfg, ParallelConfig.parse(args["config"]))
        tr = Trainer(model, opt)
        hm = tr.apply_plan(plan, devices="cpu")
        hm.__enter__()
    mp = mesh_plan_of(model)
    out = {"config": np.asarray(plan.config_str)}
    batch = _batch(inp)
    for _ in range(args.get("steps", 0)):
        tr.train_step(batch)
    root = args.get("root", os.path.join(os.getcwd(), "ckpt"))
    if args.get("restore"):
        mgr = CheckpointManager(os.path.join(root, args["restore"]),
                                mesh=mp, plan=plan)
        step, tree = mgr.restore(tr._ckpt_tree())
        tr._apply_restored(tree)
        out["restored_step"] = np.asarray(step)
        out["quarantined"] = np.asarray(json.dumps(mgr.quarantined()))
        flat = checkpoint.load_flat(mgr.step_dir(step))
        same = True
        st = tr.optimizer._state
        for n, p in tr.params.items():
            if mp.level not in ("os", "os_g"):
                same &= torch.equal(_local(p).detach(), _param_local(
                    mp, n, flat[f"params/{n}"]))
            for sk, t in st["slots"][n].items():
                same &= torch.equal(t, _param_local(
                    mp, n, flat[f"opt_state/slots/{n}/{sk}"]))
        out["equal_shard_layer"] = np.asarray(bool(same))
        mgr.close()
    if args.get("save"):
        mgr = CheckpointManager(os.path.join(root, args["save"]),
                                save_interval_steps=1, keep_last_n=4,
                                mesh=mp, plan=plan)
        for s_ in args.get("save_steps", [4]):
            mgr.save(s_, tr._ckpt_tree())
        mgr.close()
    if args.get("loader"):
        from paddle_tpu_torch.io import DataLoader, Dataset

        class Rows(Dataset):
            def __len__(self):
                return batch["input_ids"].shape[0]

            def __getitem__(self, i):
                return {k: v[i].numpy() for k, v in batch.items()}
        want = mp.local_batch(batch)
        ok = True
        for sh in (plan, mp):
            got = next(iter(DataLoader(Rows(), batch_size=len(Rows()),
                                       sharding=sh)))
            ok &= bool(getattr(got, "is_local", False)) and all(
                torch.equal(got[k], want[k]) for k in want)
        out["loader_local"] = np.asarray(ok)
    if args.get("losses"):
        out["losses"] = np.asarray([float(tr.train_step(b)) for b in (
            _batch(inp, "batch0/"), _batch(inp, "batch1/"))])
        from paddle_tpu_torch.parallel.api import full_state_dict
        for k, v in full_state_dict(model).items():
            out["param." + k] = _np(v)
    hm.__exit__(None, None, None)
    return out


def sc_zero1(inp, args):
    """The tiny Llama on ``args["mesh"]`` (an fsdp axis) under
    ``DygraphShardingOptimizer`` (ZeRO-1) over a Momentum optimizer with
    a global-norm clip, bound to the model's plan, whose zero state was
    made before wrapping (so the wrapper cuts it): ``args["steps"]``
    steps on the global batch, each rank on its rows. Returns this
    rank's parameters (its own copies, and in the JAX layout), the
    element count of each state tensor on this rank, the plan's level
    and what ``reduce_gradients`` returned."""
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        DygraphShardingOptimizer
    from paddle_tpu_torch.distributed.sharding import bind_optimizer
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm, Momentum
    from paddle_tpu_torch.parallel.api import full_state_dict, shard_layer
    model = _model(inp, args)
    hm = _mesh(args)
    opt = Momentum(learning_rate=0.1, momentum=0.9, parameters=model,
                   grad_clip=ClipGradByGlobalNorm(1.0))
    out = {}
    with hm:
        shard_layer(model, hm)
        bind_optimizer(opt, model)
        opt.ensure_state(opt._bound_params)
        zopt = DygraphShardingOptimizer(opt)
        plan = model._mesh_plan
        batch = plan.local_batch(_batch(inp))
        for _ in range(args.get("steps", 3)):
            model(**batch, return_logits=False).backward()
            zopt.step()
            zopt.clear_grad()
        out["level"] = np.asarray(plan.level)
        out["reduce_gradients"] = np.asarray(zopt.reduce_gradients() is None)
        for k, slots in opt._state["slots"].items():
            out["numel." + k] = np.asarray(slots["velocity"].numel())
        for k, v in full_state_dict(model).items():
            out["jax." + k] = _np(v)
    for k, p in model.named_parameters():
        out["param." + k] = _np(p)
    return out


def sc_generate(inp, args):
    """One-shot generation of the tiny Llama (the parent's weights)
    sharded over this mesh: the greedy tokens of ``generate``,
    ``generate_scan`` and ``generate_paged`` (page 8) and the sampled
    tokens of ``generate_scan``; the sharded pools' KV heads; and the
    refusal of an int8 model, whose message names its ROADMAP row."""
    import torch
    from paddle_tpu_torch.inference import generation as gen
    from paddle_tpu_torch.parallel.api import shard_layer
    from paddle_tpu_torch.quantization import quantize_model
    model = _model(inp, args)
    q = quantize_model(model, kv_dtype="int8")
    ids = inp["gen_ids"]
    greedy = gen.GenerationConfig(max_new_tokens=int(inp["gen_new"]))
    sampled = gen.GenerationConfig(max_new_tokens=int(inp["gen_new"]),
                                   **args["sampled"])
    out = {}
    with _mesh(args) as hm:
        shard_layer(model, hm)
        for name in ("generate", "generate_scan", "generate_paged"):
            kw = {"page_size": 8} if name == "generate_paged" else {}
            out[name] = getattr(gen, name)(model, ids, greedy, **kw).numpy()
        out["sampled_scan"] = gen.generate_scan(model, ids, sampled).numpy()
        fed = []
        step = model.model.decode_step
        model.model.decode_step = lambda t, p, c: (fed.append(t[0].item()),
                                                   step(t, p, c))[1]
        out["eos_scan"] = gen.generate_scan(model, ids, gen.GenerationConfig(
            max_new_tokens=int(inp["gen_new"]),
            eos_token_id=int(inp["gen_eos"]), pad_token_id=-1)).numpy()
        model.model.decode_step = step
        out["fed_pad"] = np.asarray(fed[1])   # fed[0] is the EOS itself
        pools, _ = model.model.alloc_paged_caches(1, 16, 8)
        out["pool_heads"] = np.asarray(pools[0][0].shape[0])
        try:
            shard_layer(q, hm)
            out["int8_refused"] = np.asarray("")
        except ValueError as e:
            out["int8_refused"] = np.asarray(str(e))
    assert not torch.is_inference_mode_enabled()
    return out


def sc_graph_contracts(inp, args):
    """The four sharded graphs of ``analysis.graphs`` on this rank,
    checked against the checked-in budgets (``graph_lint.check``), and
    the planted faults: one more tp all-reduce in the vocab-parallel CE
    head, the planner's step emitted through a drifted (dp4) plan, and
    the dropless ep step's host reads (D18). Everything as JSON text."""
    import torch
    from paddle_tpu_torch import analysis as A
    from paddle_tpu_torch.analysis import graphs as G
    from paddle_tpu_torch.distributed.auto_parallel import (
        ParallelConfig, plan_for_config)
    from paddle_tpu_torch.models.moe_lm import MoEForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.tools import graph_lint
    from paddle_tpu_torch.trainer import Trainer
    budgets = A.load_budgets(graph_lint.DEFAULT_BUDGETS)
    viol, snaps, skipped, reps = graph_lint.check(
        G.SHARDED, "cpu", budgets, log=lambda m: None)
    out = {"violations": [v.render() for v in viol], "snapshots": snaps,
           "skipped": skipped,
           "tp_ops": [c.op_name for c in
                      reps["tp_fused_ce"][1].collectives["table"]]}

    def rules(g):
        rep = A.analyze(g.census, g.name, g.contract, mesh=g.mesh)
        return [(v.rule, v.lines) for v in A.check_contract(g.contract,
                                                             rep)]
    out["extra_all_reduce"] = rules(G.build_tp_fused_ce(
        "cpu", extra_all_reduce=True))
    out["drifted_plan"] = rules(G.build_planner(
        "cpu", drift_to="dp4_tp1_pp1_sep1"))
    cfg = G.moe_micro_cfg(capacity_factor=None)
    model = MoEForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    tr = Trainer(model, AdamW(learning_rate=1e-3, parameters=model))
    hm = tr.apply_plan(plan_for_config(cfg, ParallelConfig(dp=4, ep=2)),
                       devices="cpu")
    batch = G._batch(torch.device("cpu"), b=4, s=32)
    with hm:
        c, _ = G._census(torch.device("cpu"),
                         lambda: tr.train_step(batch), None)
    out["dropless_syncs"] = [h.describe() for h in c.host_syncs]
    return {"results": np.asarray(json.dumps(out))}


SCENARIOS = {"train": sc_train, "shards": sc_shards, "specs": sc_specs,
             "collectives": sc_collectives, "reshard": sc_reshard,
             "tp_layers": sc_tp_layers, "sp_attention": sc_sp_attention,
             "sharded_save": sc_sharded_save, "refused": sc_refused,
             "mesh_check": sc_mesh_check, "pipe_train": sc_pipe_train,
             "moe_layer": sc_moe_layer, "overlap": sc_overlap,
             "fleet_overlap": sc_fleet_overlap, "plan_state": sc_plan_state,
             "zero1": sc_zero1, "generate": sc_generate,
             "mesh_generate": sc_mesh_generate,
             "graph_contracts": sc_graph_contracts}


def torn_save(tmp: str, rank: int) -> None:
    """One of 2 gloo ranks of the torn-save check: the tiny Llama under the
    dp2 plan, step 4 saved and committed, then an async save of step 8
    from which rank 1 dies before its files are durable. Rank 0's commit
    must fail (the index waits for every rank's files), no step_8 may
    appear, and a fresh manager's startup sweep quarantines the torn
    directory; rank 0 writes what it saw to ``torn.json``."""
    import datetime
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.resilience import CheckpointManager
    from paddle_tpu_torch.trainer import Trainer
    tmp = pathlib.Path(tmp)
    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    model = LlamaForCausalLM(cfg, device="cpu")
    tr = Trainer(model, AdamW(learning_rate=1e-3, parameters=model))
    plan = plan_for_config(cfg, ParallelConfig(dp=2))
    hm = tr.apply_plan(plan, devices="cpu")
    root = str(tmp / "ckpt")
    mgr = CheckpointManager(root, mesh=tr._plan, plan=plan)
    with hm:
        mgr.save(4, tr._ckpt_tree())
        mgr.save(8, tr._ckpt_tree(), async_save=True)
    if rank == 1:
        os._exit(0)                 # dies before its writer is durable
    out = {}
    try:
        mgr.finalize()
        out["finalize"] = "committed"
    except Exception as e:  # noqa: BLE001 — what the commit did is the result
        out["finalize"] = type(e).__name__
    out["step_8_exists"] = os.path.isdir(os.path.join(root, "step_8"))
    fresh = CheckpointManager(root)
    out["committed"] = fresh.committed_steps()
    out["quarantined"] = fresh.quarantined()
    (tmp / "torn.json").write_text(json.dumps(out))
    os._exit(0)


def main(tmp: str, rank, world) -> None:
    """One rank: ``rank`` and ``world`` given, or None to take them from
    the launcher's environment."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    if rank is None:
        world = int(os.environ["WORLD_SIZE"])
        init_parallel_env(dp=world, backend="gloo", device="cpu")
        rank = dist.get_rank()
    else:
        init_parallel_env(dp=world, backend="gloo", device="cpu",
                          init_method=f"file://{tmp / 'store'}",
                          world_size=world, rank=rank)
    inp = dict(np.load(tmp / "inputs.npz"))
    out = {}
    for sc in json.loads((tmp / "scenarios.json").read_text()):
        res = SCENARIOS[sc["fn"]](inp, sc.get("args", {}))
        out.update({f"{sc['key']}/{k}": v for k, v in res.items()})
        dist.barrier()
    np.savez(tmp / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[2] == "torn":
        torn_save(sys.argv[1], int(sys.argv[3]))
    elif sys.argv[2] == "env":
        main(sys.argv[1], None, None)
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
