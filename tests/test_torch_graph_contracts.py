"""Graph contracts of the port (``paddle_tpu_torch.analysis``) on the
CPU: the census every analyzer reads, the canonical single-process
graphs against the checked-in budgets, the planted faults each contract
must catch (the naive loss head, a lost in-place update, a host read in
a tick), the linter against the JAX package's on paired snippets, the
planner's per-op dispatch floor, and ``graph_lint --device cpu``. The
four sharded graphs run in ``test_torch_graph_contracts_mesh.py`` (one
4-rank gloo spawn)."""

import json
import os

import pytest
import torch

import paddle_tpu_torch.analysis as A
from paddle_tpu.analysis import trace_lint as jlint
from paddle_tpu_torch.analysis import collectives as col
from paddle_tpu_torch.analysis import graphs as G
from paddle_tpu_torch.analysis import trace_lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGETS = os.path.join(ROOT, "paddle_tpu_torch", "tools",
                       "graph_budgets.json")
JAX_BUDGETS = os.path.join(ROOT, "tools", "graph_budgets.json")
SINGLE = [n for n in G.graph_names() if n not in G.SHARDED]


@pytest.fixture(scope="module")
def built():
    """Every single-process graph, built once on the CPU."""
    out = {}
    for n in SINGLE:
        g = A.build_graph(n, "cpu")
        out[n] = (g, A.analyze(g.census, n, g.contract))
    return out


def _violations(rep, g=None, entry=None):
    v = A.check_contract(g.contract, rep) if g is not None else []
    if entry is not None:
        v += A.check_budget(rep, entry)
    return v


# -- the census ---------------------------------------------------------------

def test_census_records_buffers_writes_syncs_and_saves():
    x = torch.randn(4, 8)
    w = torch.randn(8, 16)
    acc = torch.zeros(4, 16)
    tolist = torch.Tensor.tolist
    with col.StepCensus(inputs={"acc": acc, "w": w}) as c:
        y = x @ w                         # a fresh [4, 16] buffer
        acc.add_(y)                       # acc written in place
        float(y.sum())                    # a host read
        with col.kernel("k", lambda: (10.0, 20.0)) as k:
            z = k.out(torch.ones(3, 5) + 0)   # the kernel's output only
            z.tolist()                    # a plain route's read: not one
    assert z.shape == (3, 5) and torch.Tensor.tolist is tolist
    names = [o.name for o in c.ops]
    assert "aten.mm" in names and names[-1] == "k"
    assert [str(l) for l in c.ops[-1].outputs] == ["f32[3,5]"]
    assert any(str(l) == "f32[4,16]" for o in c.ops for l in o.outputs)
    assert [h.op for h in c.host_syncs] == ["aten._local_scalar_dense"]
    assert "test_torch_graph_contracts.py" in c.host_syncs[0].where
    d = A.donation_report(c)
    assert [a["label"] for a in d["aliased"]] == ["acc"]
    rec = col.from_json(json.loads(json.dumps(col.to_json(c))))
    for key in ("donation", "transfers", "materialization"):
        got, want = A.analyze(rec, "g"), A.analyze(c, "g")
        assert json.dumps(getattr(got, key), default=str) == \
            json.dumps(getattr(want, key), default=str)
    assert A.snapshot_report(A.analyze(rec)) == \
        A.snapshot_report(A.analyze(c))


def test_replaced_inputs_are_candidates_only_at_their_shape():
    box = {"a": torch.zeros(4), "b": torch.zeros(4)}
    with col.StepCensus(inputs=lambda: dict(box)) as c:
        box["a"] = box["a"] + 1          # same leaf: could be in place
        box["b"] = torch.zeros(8)        # another shape: no candidate
    d = A.donation_report(c)
    assert [x.label for x in d["undonated_candidates"]] == ["a"]
    assert d["aliased"] == [] and d["donated_bytes"] == 0


def test_unwaited_async_collective_raises_and_waits_price_windows():
    rec = col.CensusRecord(ops=[col.OpCost("aten.mm", 2e9, 1e6)] * 3)
    rec.collectives = [col.CollectiveInstr("all-reduce", 10 ** 6, (0, 1),
                                           "dp", "c10d.allreduce_", 0,
                                           True, None)]
    with pytest.raises(A.UnmatchedCollectiveError, match="all-reduce"):
        A.overlap_report(rec)
    rec.collectives[0].done_index = 3
    ov = A.overlap_report(rec)
    assert ov["min_overlap_distance"] == 3 and ov["async_collectives"] == 1
    rec.collectives[0].is_async = False      # synchronous: fully exposed
    assert A.overlap_report(rec)["exposed_comm_fraction"] == 1.0


# -- the canonical graphs -------------------------------------------------------

def test_package_exports_jax_s_names():
    """JAX's ``analysis.__all__`` but its HLO parser (the census record
    is its counterpart), each name resolving."""
    import paddle_tpu.analysis as J
    want = set(J.__all__) - {"parse_hlo", "HloModule"}
    assert want <= set(A.__all__)
    for name in A.__all__:
        assert getattr(A, name) is not None


def test_all_eleven_jax_names_have_builders():
    with open(JAX_BUDGETS) as f:
        jax_names = set(json.load(f)["graphs"])
    assert set(G.graph_names()) == jax_names and len(jax_names) == 11


@pytest.mark.parametrize("name", SINGLE)
def test_graph_holds_contract_and_checked_in_budget(built, name):
    g, rep = built[name]
    entry = A.load_budgets(BUDGETS)["graphs"][name]
    assert _violations(rep, g, entry) == []


def test_budgets_are_jax_semantics_and_hold_jax_zero_transfers(built):
    """The budget file's semantics table is JAX's key for key, and every
    graph JAX pins at 0 host transfers is 0 here (the sharded ones in
    the mesh test)."""
    with open(JAX_BUDGETS) as f:
        jax = json.load(f)
    mine = A.load_budgets(BUDGETS)
    assert mine["_meta"]["semantics"] == jax["_meta"]["semantics"]
    assert set(mine["graphs"]) == set(jax["graphs"])
    for name, entry in jax["graphs"].items():
        if entry["budget"]["host_transfer_count"] == 0:
            assert mine["graphs"][name]["budget"][
                "host_transfer_count"] == 0, name
            if name in built:
                assert built[name][1].transfers[
                    "host_transfer_count"] == 0, name


def test_trainer_state_and_pools_are_updated_in_place(built):
    rep = built["train_step_k1"][1]
    labels = {a["label"] for a in rep.donation["aliased"]}
    assert any(l.startswith("params[") for l in labels)
    assert any(l.startswith("opt_state['slots']") for l in labels)
    assert rep.donation["undonated_candidates"] == []
    spec = built["serving_tick_spec"][1]
    labels = {a["label"] for a in spec.donation["aliased"]}
    assert "hist" in labels and "pools[0][0]" in labels


@pytest.mark.parametrize("name", ["train_step_k1", "serving_tick_quant",
                                  "fused_ce"])
def test_graph_outputs_are_the_seeds_alone(built, name):
    """A graph's outputs (the censused call's returns and its named
    inputs after it, as CPU copies) depend on the seeds alone: a second
    build gives them bit for bit. The card's run holds its outputs
    against a CPU build's on this."""
    want = built[name][0].outputs
    got = A.build_graph(name, "cpu").outputs
    assert "out[0]" in want and len(want) > 2
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert t.device.type == "cpu" and torch.equal(got[k], t), k


# -- planted faults --------------------------------------------------------------

def test_naive_loss_head_fails_the_logits_ban(monkeypatch, built):
    """PT_NAIVE_LOSS_HEAD=1 materializes [B*S, V] logits: the train-step
    ban names the buffer and the op; the fused head (the default) and
    the standalone fused CE pass it."""
    monkeypatch.setenv("PT_NAIVE_LOSS_HEAD", "1")
    g = A.build_graph("train_step_k1", "cpu")
    rep = A.analyze(g.census, g.name, g.contract)
    ban = [v for v in A.check_contract(g.contract, rep)
           if v.rule == "materialization.ban"]
    assert ban, "the naive head must trip the BSV ban"
    text = ban[0].render()
    assert "320]" in text and "B) <- op" in text and "aten." in text
    for name in ("train_step_k1", "fused_ce"):
        assert built[name][1].materialization["banned"] == []


def test_undonated_trainer_fails_the_donation_floor():
    """The undonated step, as ``fit`` runs it under
    ``AnomalyGuard(policy="skip")``: the pre-step clone of every
    parameter and slot before the update is a second copy, so the
    in-place requirement and the checked-in donated-bytes floor fail,
    naming the inputs."""
    g = G.build_train_step_k1("cpu", donate=False)
    rep = A.analyze(g.census, g.name, g.contract)
    rules = {v.rule for v in A.check_contract(g.contract, rep)}
    assert {"donation.require_aliased[params]",
            "donation.require_aliased[opt_state]"} <= rules
    entry = A.load_budgets(BUDGETS)["graphs"]["train_step_k1"]
    v = {x.rule: x for x in A.check_budget(rep, entry)}
    assert "budget.donated_bytes" in v and rep.donation["donated_bytes"] == 0
    assert "(not in place)" in "\n".join(v["budget.donated_bytes"].lines)
    assert all(c.why == "copied"
               for c in rep.donation["undonated_candidates"])


def test_rebound_pools_fail_the_donation_floor():
    """A decode block that rebinds the KV pools to new tensors instead of
    writing them in place: pools replaced, not aliased."""
    eng = G._engine(torch.device("cpu"))
    entry = A.load_budgets(BUDGETS)["graphs"]["serving_tick"]

    def rebound():
        eng.pools = [tuple(t.clone() for t in e) for e in eng.pools]
        return eng._decode_block(4, False)
    c, _ = G._census(torch.device("cpu"), rebound,
                     lambda: G.engine_inputs(eng), G._paged_modes())
    contract = A.GraphContract("serving_tick", require_aliased=("pools",))
    rep = A.analyze(c, "serving_tick", contract)
    rules = {v.rule for v in A.check_contract(contract, rep)
             + A.check_budget(rep, entry)}
    assert {"donation.require_aliased[pools]", "budget.donated_bytes",
            "budget.undonated_candidates"} <= rules
    assert {x.why for x in rep.donation["undonated_candidates"]} == \
        {"replaced"}


def test_host_read_in_a_tick_fails_the_transfer_ceiling(monkeypatch):
    """An .item() planted in the decode block's sampler: the ceiling
    fails and the message names the op and the line."""
    eng = G._engine(torch.device("cpu"))
    real = eng._pick

    def reads(lf, off, any_sample):
        lf.max().item()
        return real(lf, off, any_sample)
    monkeypatch.setattr(eng, "_pick", reads)
    c, _ = G._census(torch.device("cpu"),
                     lambda: eng._decode_block(4, False),
                     lambda: G.engine_inputs(eng), G._paged_modes())
    contract = A.GraphContract("serving_tick", max_host_transfers=0)
    rep = A.analyze(c, "serving_tick", contract)
    v = [x for x in A.check_contract(contract, rep)
         if x.rule == "transfers.max_host_transfers"]
    assert v and "4 host sync(s)" in v[0].message
    assert "aten.item" in v[0].lines[0]
    assert "test_torch_graph_contracts.py" in v[0].lines[0]
    entry = A.load_budgets(BUDGETS)["graphs"]["serving_tick"]
    assert "budget.host_transfer_count" in {
        x.rule for x in A.check_budget(rep, entry)}


def test_budget_floor_and_exact_counts_catch_drift(built):
    """Budget semantics (JAX's test_budget_floor_catches_donation_drop):
    a donated-bytes floor one byte over the graph fails; so does a
    collective count the graph does not make."""
    g, rep = built["prefix_admit"]
    snap = A.snapshot_report(rep)
    entry = {"budget": dict(snap), "waivers": {}}
    assert A.check_budget(rep, entry) == []
    entry["budget"]["donated_bytes"] = snap["donated_bytes"] + 1
    assert any(v.rule == "budget.donated_bytes"
               for v in A.check_budget(rep, entry))
    entry["budget"]["donated_bytes"] = snap["donated_bytes"]
    entry["budget"]["collective_counts"] = {"all-gather[tp]": 1}
    v = A.check_budget(rep, entry)
    assert [x.rule for x in v] == ["budget.collective_counts"]
    assert "all-gather[tp]: budget 1 -> actual 0" in v[0].lines


# -- the linter -------------------------------------------------------------------

# (JAX source, port source): the same hazards at the same lines, a
# jax.jit body against an autograd.Function's forward
PAIRS = [
    ("import jax\n"
     "@jax.jit\n"
     "def body(x, y):\n"
     "    v = float(x.sum())\n"
     "    return v\n",
     "import torch\n"
     "class F(torch.autograd.Function):\n"
     "    def forward(ctx, x, y):\n"
     "        v = float(x.sum())\n"
     "        return v\n"),
    ("import jax, time, numpy as np\n"
     "@jax.jit\n"
     "def step(c, x):\n"
     "    t = time.time()\n"
     "    r = np.random.rand()\n"
     "    q = x.item()\n"
     "    w = x.tolist()\n"
     "    return c, x\n",
     "import torch, time, numpy as np\n"
     "class F(torch.autograd.Function):\n"
     "    def forward(ctx, c, x):\n"
     "        t = time.time()\n"
     "        r = np.random.rand()\n"
     "        q = x.item()\n"
     "        w = x.tolist()\n"
     "        return x\n"),
    ("import jax\n"
     "@jax.jit\n"
     "def body(x, n):\n"
     "    if x:\n"
     "        return x\n"
     "    m = int(x.shape[0])\n"
     "    if n is None:\n"
     "        return x\n"
     "    a = np.asarray(x)\n"
     "    return x\n",
     "import torch\n"
     "class F(torch.autograd.Function):\n"
     "    def forward(ctx, x, n):\n"
     "        if x:\n"
     "            return x\n"
     "        m = int(x.shape[0])\n"
     "        if n is None:\n"
     "            return x\n"
     "        a = np.asarray(x)\n"
     "        return x\n"),
    ("import jax\n"
     "for k in range(3):\n"
     "    f = jax.jit(lambda x: x)  # trace-lint: waive(jit-in-loop) sweep\n"
     "for k in range(3):\n"
     "    g = jax.jit(lambda x: x)\n",
     "import torch\n"
     "for k in range(3):\n"
     "    f = torch.compile(lambda x: x)  # trace-lint: waive(jit-in-loop) sweep\n"
     "for k in range(3):\n"
     "    g = torch.compile(lambda x: x)\n"),
    ("import jax\n"
     "def outer(a):\n"
     "    def inner(c, i):\n"
     "        return c, float(c.sum())\n"
     "    return jax.lax.scan(inner, a, None)\n"
     "out = jax.jit(outer)\n",
     "import torch\n"
     "def outer(a):\n"
     "    def inner(c, i):\n"
     "        return c, float(c.sum())\n"
     "    return torch.utils.checkpoint.checkpoint(inner, a, None)\n"
     "out = torch.compile(outer)\n"),
]


def _flags(vs):
    return [(v.line, v.rule, v.waived, v.waiver_reason) for v in vs]


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_linter_flags_what_jax_flags(i):
    jsrc, psrc = PAIRS[i]
    assert _flags(trace_lint.lint_source(psrc)) == \
        _flags(jlint.lint_source(jsrc))
    assert trace_lint.lint_source(psrc), "the pair must flag something"


def test_port_only_hazards_and_static_tests():
    src = ("import torch, random\n"
           "class F(torch.autograd.Function):\n"
           "    def forward(ctx, x, mode):\n"
           "        torch.cuda.synchronize()\n"
           "        y = x.cpu()\n"
           "        i = torch.nonzero(x)\n"
           "        z = x[x > 0]\n"
           "        n = torch.randn(3)\n"
           "        m = torch.randn(3, generator=g)\n"
           "        r = random.random()\n"
           "        if mode == 'mean':\n"
           "            return x\n"
           "        if _plain(x) or x.shape[0] > 1:\n"
           "            return x\n"
           "        return y\n"
           "for _ in range(2):\n"
           "    torch.cuda.CUDAGraph()\n")
    got = [(v.line, v.rule) for v in trace_lint.lint_source(src)]
    assert got == [(4, "host-sync"), (5, "host-sync"), (6, "host-sync"),
                   (7, "host-sync"), (8, "host-rng"), (10, "host-rng"),
                   (17, "jit-in-loop")]


def test_waiver_grammar_is_jax_s():
    assert trace_lint._WAIVE_RE.pattern == jlint._WAIVE_RE.pattern
    v = trace_lint.Violation("p.py", 3, "host-sync", "m", True, "why")
    w = jlint.Violation("p.py", 3, "host-sync", "m", True, "why")
    assert v.render() == w.render()
    assert trace_lint.RULES == jlint.RULES


def test_port_hot_paths_lint_clean_with_reasoned_waivers():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    vs = trace_lint.lint_paths([os.path.join(pkg, p) for p in
                                ("trainer", "inference", "ops",
                                 "analysis")])
    hard = [v for v in vs if not v.waived]
    assert hard == [], "\n".join(v.render() for v in hard)
    assert all(len(v.waiver_reason) > 10 for v in vs if v.waived)
    roots = {r for _, r in trace_lint.HOT_ROOTS}
    assert {"Trainer._one_step", "ContinuousBatchingEngine._decode_block",
            "ContinuousBatchingEngine._spec_tick"} <= roots


# -- the planner's per-op dispatch floor -------------------------------------

def test_planner_prices_the_floor_per_dispatched_op(tmp_path):
    from paddle_tpu_torch.distributed.auto_parallel import planner
    from paddle_tpu_torch.observability import costs
    from paddle_tpu_torch.ops.kernels import autotune as tune
    spec = costs.device_spec()
    db = tune.OpCostDB(user_path=str(tmp_path / "c.json"))
    db.record(tune.OpCostDB.graph_key("train_step_k1", spec.kind),
              {"t_s": 0.01, "dispatch_floor_s": 0.004,
               "dispatch_floor_per_op_s": 1e-5, "captured_at": "x"})
    lin = torch.nn.Linear(16, 8)
    with col.StepCensus() as c:
        lin(torch.randn(4, 16)).sum().backward()
    got = planner.price_compiled(c, spec=spec, db=db)
    assert got.dispatch_s == pytest.approx(1e-5 * len(c.ops))
    plain = planner.price_compiled(c, spec=spec)
    assert got.predicted_step_s == pytest.approx(
        plain.predicted_step_s + 1e-5 * len(c.ops))


# -- the gate ---------------------------------------------------------------------

def test_graph_lint_tool_in_process():
    """``graph_lint --device cpu`` (the gate): every single-process graph
    green against the checked-in budgets, the linter clean, the sharded
    graphs left to a world of 4."""
    from paddle_tpu_torch.tools import graph_lint
    out = graph_lint.main(verbose=False, device="cpu")
    assert out["ok"], "\n".join(out["violations"])
    assert sorted(out["snapshots"]) == sorted(SINGLE)
    assert out["skipped"] == [] and out["trace_lint"]["violations"] == 0
    assert out["trace_lint"]["waived"] >= 1
