"""AST linter for host-sync and capture hazards in the port's hot Python
paths (counterpart of ``paddle_tpu/analysis/trace_lint.py``).

The census analyzers catch what one run of a call dispatched; this
linter catches the pattern at the source line. JAX's linter marks the
functions that get traced; the eager port has no trace, so its hot
functions are the code the card waits on every step and every tick, and
what a CUDA graph (ROADMAP B.3.3) would capture. A function is *hot*
when it is:

* ``forward`` / ``backward`` of a ``torch.autograd.Function`` subclass;
* a callable passed to ``torch.utils.checkpoint.checkpoint``,
  ``torch.cuda.graph``, ``torch.cuda.make_graphed_callables``,
  ``torch.compile`` or ``torch.func.*`` (by name, module-wide, as JAX's
  tracer arguments are), or a def decorated with ``torch.compile``;
* a root in :data:`HOT_ROOTS`, which maps each JAX jit site to its port
  counterpart;
* a ``def`` nested in any of the above.

Inside hot code it flags:

* ``host-sync``    — ``.item()`` / ``.tolist()`` / ``.cpu()`` /
  ``.numpy()``, ``float()`` / ``int()`` / ``bool()`` of a computed value,
  ``np.asarray`` / ``np.array`` of one, ``torch.cuda.synchronize``, and
  the ops whose output shape depends on the data (``nonzero``,
  ``masked_select``, ``unique``, boolean-mask indexing ``x[a > b]``):
  the host waits for the card, and a capture cannot hold it;
* ``host-time``    — ``time.time()`` / ``perf_counter()`` /
  ``datetime.now()``: the clock reads the enqueue, not the card, and a
  captured graph replays without it;
* ``host-rng``     — Python ``random.*`` and ``np.random.*``, and a torch
  sampler (``torch.rand``, ``randn``, ``randint``, ``randperm``,
  ``multinomial``, ``normal``, ``bernoulli``, ``*_like``, the in-place
  ``uniform_`` ...) called without an explicit ``generator=``: the
  port's streams are explicit generators (``device.generator``), so a
  draw from the global stream breaks replay;
* ``nonstatic-branch`` — ``if`` / ``while`` on a bare parameter of the
  hot function: Python control flow on a tensor reads it on the host.

Plus one host-side rule, applied everywhere:

* ``jit-in-loop``  — ``torch.compile(...)``, ``torch.cuda.graph(...)``,
  ``torch.cuda.CUDAGraph()`` or ``make_graphed_callables(...)`` built
  inside a ``for`` / ``while`` body: a fresh compile or capture every
  iteration.

False positives are expected at the margins (the linter has no
dataflow); an intended sync carries an inline waiver, with its reason::

    n = int(lens.max())   # trace-lint: waive(host-sync) the pool size

A waiver comment on the flagged line (or the line directly above) names
the rule it waives and MUST carry a reason; unwaived violations fail
``tools/graph_lint.py`` and the contract tests.

CLI: ``python -m paddle_tpu_torch.analysis.trace_lint <paths...>``.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["Violation", "lint_source", "lint_file", "lint_paths",
           "RULES", "HOT_ROOTS", "main"]

RULES = ("host-sync", "host-time", "host-rng", "nonstatic-branch",
         "jit-in-loop")

#: (file under paddle_tpu_torch/, Class.method or function) of each hot
#: root, with the JAX jit site it stands for
HOT_ROOTS: Tuple[Tuple[str, str], ...] = (
    # Trainer._step_jit (paddle_tpu/trainer/trainer.py): one step
    ("trainer/trainer.py", "Trainer._one_step"),
    # Trainer._superstep_jit: K steps in one dispatch
    ("trainer/trainer.py", "Trainer._dispatch"),
    # ContinuousBatchingEngine._build_decode: the decode block
    ("inference/serving.py", "ContinuousBatchingEngine._decode_block"),
    # _build_spec_decode: draft + verify + commit
    ("inference/serving.py", "ContinuousBatchingEngine._spec_tick"),
    # the chunked prefill's jitted chunk
    ("inference/serving.py", "ContinuousBatchingEngine._chunk_step"),
    # _tail_logits_fn: the full-prompt hit's COW + one-token re-forward
    ("inference/serving.py", "ContinuousBatchingEngine._tail_logits"),
    # fused_linear_cross_entropy's jitted head
    ("ops/vocab_ce.py", "fused_linear_cross_entropy"),
    ("ops/vocab_ce.py", "lse_and_target"),
)

# callables whose function-typed arguments run hot
_TRACERS = {"checkpoint", "compile", "graph", "make_graphed_callables",
            "vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev",
            "jacfwd", "hessian", "functional_call"}
_HOST_SYNC_CASTS = {"float", "int", "bool", "complex"}
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_DATA_SHAPE = {"nonzero", "masked_select", "unique", "unique_consecutive",
               "argwhere"}
_NP_ARRAYIFY = {"asarray", "array", "copy"}
_TIME_FNS = {"time", "perf_counter", "monotonic", "process_time",
             "perf_counter_ns", "time_ns"}
_SAMPLERS = {"rand", "randn", "randint", "randperm", "multinomial",
             "normal", "bernoulli", "poisson", "rand_like", "randn_like",
             "randint_like"}
_INPLACE_SAMPLERS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                     "random_", "geometric_", "cauchy_", "log_normal_"}
_CAPTURES = {"compile", "CUDAGraph", "make_graphed_callables"}
# tests that read a tensor's device or metadata, not its values
_ROUTE_TESTS = {"_plain", "plain_route"}
_META = {"shape", "dtype", "device", "ndim", "requires_grad", "is_cuda",
         "is_leaf"}

_WAIVE_RE = re.compile(r"trace-lint:\s*waive\(([\w\-, ]+)\)\s*(.*)")


@dataclass
class Violation:
    path: str
    line: int
    rule: str
    message: str
    waived: bool = False
    waiver_reason: str = ""

    def render(self) -> str:
        tag = " [waived]" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}{tag}: {self.message}"


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for an Attribute/Name chain, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_static_arg(node: ast.AST) -> bool:
    """Arguments that are obviously NOT tensor values: literals, shape
    attribute chains (.shape / .ndim / .size / .dtype), len(), and
    arithmetic over those — enough to keep static shape math quiet."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in ("shape", "ndim", "size", "dtype")
    if isinstance(node, ast.Subscript):
        return _is_static_arg(node.value)
    if isinstance(node, ast.Call):
        f = _dotted(node.func)
        if f == "len" or f.endswith(".prod") or f.endswith(".ceil") \
                or f.endswith(".floor") or f.endswith(".numel") \
                or f.endswith(".dim") or f.endswith(".size"):
            return all(_is_static_arg(a) for a in node.args)
        return False
    if isinstance(node, ast.BinOp):
        return _is_static_arg(node.left) and _is_static_arg(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_static_arg(node.operand)
    return False


def _is_str(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any(_dotted(b).rsplit(".", 1)[-1] == "Function"
               and "autograd" in _dotted(b) or _dotted(b) == "Function"
               for b in cls.bases)


def _roots_for(path: str) -> Set[str]:
    p = path.replace(os.sep, "/")
    return {name for suffix, name in HOT_ROOTS
            if p.endswith("paddle_tpu_torch/" + suffix)}


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.violations: List[Violation] = []
        self._roots = _roots_for(path)
        self._hot_depth = 0          # >0: inside a hot function body
        self._loop_depth = 0
        self._params: List[Set[str]] = []
        self._hot_nodes: Set[ast.AST] = set()
        self._class: List[ast.ClassDef] = []

    # -- waiver lookup -------------------------------------------------------

    def _waiver(self, line: int, rule: str) -> Optional[str]:
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = _WAIVE_RE.search(self.lines[ln - 1])
                if m:
                    rules = {r.strip() for r in m.group(1).split(",")}
                    if rule in rules or "all" in rules:
                        return m.group(2).strip() or "(no reason given)"
        return None

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        reason = self._waiver(node.lineno, rule)
        self.violations.append(Violation(
            self.path, node.lineno, rule, message,
            waived=reason is not None, waiver_reason=reason or ""))

    # -- hot-function discovery ---------------------------------------------

    def _mark_hot_args(self, call: ast.Call) -> None:
        """checkpoint(fn, ...) / torch.compile(fn) / torch.func.vmap(fn):
        function-typed arguments (Name refs and lambdas) run hot."""
        fn_name = _dotted(call.func)
        last = fn_name.rsplit(".", 1)[-1]
        if last not in _TRACERS:
            return
        if last == "graph" and "cuda" not in fn_name:
            return
        if last in ("grad", "vmap", "vjp", "jvp", "grad_and_value",
                    "functional_call") and not (
                fn_name.startswith("torch.func.")
                or fn_name.startswith("func.") or fn_name == "torch.vmap"):
            return          # torch.autograd.grad & co.: not a transform
        if last == "compile" and not fn_name.startswith("torch."):
            return          # re.compile
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(arg, ast.Lambda):
                self._hot_nodes.add(arg)
            elif isinstance(arg, ast.Name):
                self._names_hot.add(arg.id)

    def visit_Module(self, node: ast.Module):
        self._names_hot: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                self._mark_hot_args(n)
        self.generic_visit(node)

    def visit_ClassDef(self, node: ast.ClassDef):
        self._class.append(node)
        outer = self._loop_depth
        self._loop_depth = 0
        self.generic_visit(node)
        self._loop_depth = outer
        self._class.pop()

    def _is_hot_def(self, node) -> bool:
        if node in self._hot_nodes or self._hot_depth > 0:
            return True
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        cls = self._class[-1] if self._class else None
        qual = f"{cls.name}.{node.name}" if cls is not None else node.name
        if qual in self._roots:
            return True
        if cls is not None and node.name in ("forward", "backward") \
                and _is_autograd_function(cls):
            return True
        args = node.args.posonlyargs + node.args.args
        is_method = bool(args) and args[0].arg in ("self", "cls")
        if node.name in self._names_hot and not is_method:
            return True
        for dec in node.decorator_list:
            d = _dotted(dec if not isinstance(dec, ast.Call) else dec.func)
            if d in ("torch.compile", "compile"):
                return True
        return False

    def _visit_fn(self, node, args: Optional[ast.arguments]):
        hot = self._is_hot_def(node)
        if hot:
            self._hot_depth += 1
            names = set()
            if args is not None:
                for a in (list(args.posonlyargs) + list(args.args)
                          + list(args.kwonlyargs)):
                    if a.arg not in ("self", "cls", "ctx"):
                        names.add(a.arg)
            self._params.append(names)
        outer_loop = self._loop_depth
        self._loop_depth = 0            # loops outside a def don't leak in
        self.generic_visit(node)
        self._loop_depth = outer_loop
        if hot:
            self._hot_depth -= 1
            self._params.pop()

    def visit_FunctionDef(self, node):
        self._visit_fn(node, node.args)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._visit_fn(node, node.args)

    # -- rules ---------------------------------------------------------------

    def visit_For(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_While(self, node):
        if self._hot_depth and self._references_param(node.test):
            self._flag(node, "nonstatic-branch",
                       "`while` on a hot function's parameter — Python "
                       "control flow on a tensor reads it on the host")
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def _references_param(self, test: ast.AST) -> bool:
        if not self._params:
            return False
        params = self._params[-1]
        # `x is None` / isinstance / hasattr tests are static dispatch on
        # Python structure, not tensor-value branching
        for n in ast.walk(test):
            if isinstance(n, ast.Compare) and any(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
                return False
            if isinstance(n, ast.Call) and _dotted(n.func) in (
                    "isinstance", "hasattr", "callable", "len"):
                return False
            # a parameter compared with a string is a Python string
            if isinstance(n, ast.Compare) and any(
                    _is_str(c) or isinstance(c, (ast.Tuple, ast.List))
                    and c.elts and all(_is_str(e) for e in c.elts)
                    for c in n.comparators):
                return False
        static = set()
        for n in ast.walk(test):
            # the device route, and a tensor's metadata, are no values
            if isinstance(n, ast.Call) and _dotted(n.func) in _ROUTE_TESTS:
                static.update(id(a) for a in ast.walk(n))
            if isinstance(n, ast.Attribute) and n.attr in _META:
                static.update(id(a) for a in ast.walk(n.value))
        for n in ast.walk(test):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in params and id(n) not in static:
                return True
        return False

    def visit_If(self, node):
        if self._hot_depth and self._references_param(node.test):
            self._flag(node, "nonstatic-branch",
                       "`if` on a hot function's parameter — Python "
                       "branching on a tensor reads it on the host (use "
                       "torch.where, or pass a Python value)")
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if self._hot_depth and isinstance(node.slice, ast.Compare):
            self._flag(node, "host-sync",
                       "boolean-mask indexing inside a hot path — its "
                       "shape is the mask's count, read on the host")
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = _dotted(node.func)
        last = fn.rsplit(".", 1)[-1]

        if self._loop_depth and (
                (last in _CAPTURES and fn.startswith("torch."))
                or fn in ("torch.cuda.graph", "cuda.graph")):
            self._flag(node, "jit-in-loop",
                       f"{fn} built inside a loop body — a fresh compile "
                       f"or capture every iteration; build it once and "
                       f"cache it")

        if self._hot_depth:
            kw = {k.arg for k in node.keywords}
            if fn in _HOST_SYNC_CASTS and node.args \
                    and not _is_static_arg(node.args[0]):
                self._flag(node, "host-sync",
                           f"{fn}() on a computed value inside a hot path "
                           f"— the host waits for the card")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_SYNC_ATTRS:
                self._flag(node, "host-sync",
                           f".{node.func.attr}() inside a hot path — a "
                           f"device->host transfer")
            elif fn in ("torch.cuda.synchronize", "cuda.synchronize"):
                self._flag(node, "host-sync",
                           f"{fn}() inside a hot path")
            elif last in _DATA_SHAPE and (fn.startswith("torch.")
                                          or isinstance(node.func,
                                                        ast.Attribute)):
                self._flag(node, "host-sync",
                           f"{fn or last}() inside a hot path — its output "
                           f"shape depends on the data, read on the host")
            elif fn.startswith("np.") and last in _NP_ARRAYIFY \
                    and node.args and not isinstance(
                        node.args[0], (ast.List, ast.Tuple, ast.Constant)):
                self._flag(node, "host-sync",
                           f"{fn}() inside a hot path makes a host array "
                           f"(of a tensor: a device->host copy)")
            elif (fn.startswith("time.") and last in _TIME_FNS) \
                    or fn in ("datetime.now", "datetime.datetime.now"):
                self._flag(node, "host-time",
                           f"{fn}() inside a hot path reads the host "
                           f"clock: the enqueue, not the card")
            elif fn.startswith("np.random.") or fn.startswith(
                    "numpy.random.") or fn.startswith("random."):
                self._flag(node, "host-rng",
                           f"{fn}() inside a hot path draws from a host "
                           f"stream — pass an explicit generator")
            elif ((fn.startswith("torch.") and last in _SAMPLERS)
                  or (isinstance(node.func, ast.Attribute)
                      and last in _INPLACE_SAMPLERS)) \
                    and "generator" not in kw:
                self._flag(node, "host-rng",
                           f"{fn or last}() without generator= draws from "
                           f"torch's global stream — pass the port's "
                           f"explicit generator")
        self.generic_visit(node)


def lint_source(source: str, path: str = "<string>") -> List[Violation]:
    tree = ast.parse(source)
    linter = _Linter(path, source)
    linter.visit(tree)
    linter.violations.sort(key=lambda v: (v.path, v.line))
    return linter.violations


def lint_file(path: str) -> List[Violation]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        return lint_source(src, path)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, "parse-error", str(e))]


def lint_paths(paths: Sequence[str]) -> List[Violation]:
    out: List[Violation] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs.sort()
                if "__pycache__" in root:
                    continue
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.extend(lint_file(os.path.join(root, f)))
        elif p.endswith(".py"):
            out.extend(lint_file(p))
    return out


def waivers(violations: Sequence[Violation]) -> Dict[str, List[str]]:
    """rule -> the waived sites, ``path:line reason``: the list of the
    hot path's intended syncs (what blocks a CUDA-graph capture)."""
    out: Dict[str, List[str]] = {}
    for v in violations:
        if v.waived:
            out.setdefault(v.rule, []).append(
                f"{v.path}:{v.line} {v.waiver_reason}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    show_waived = "--show-waived" in argv
    argv = [a for a in argv if not a.startswith("--")]
    if not argv:
        print("usage: python -m paddle_tpu_torch.analysis.trace_lint "
              "[--show-waived] <paths...>")
        return 2
    violations = lint_paths(argv)
    hard = [v for v in violations if not v.waived]
    for v in violations:
        if v.waived and not show_waived:
            continue
        print(v.render())
    print(f"{len(hard)} violation(s), "
          f"{sum(v.waived for v in violations)} waived")
    return 1 if hard else 0


if __name__ == "__main__":
    sys.exit(main())
