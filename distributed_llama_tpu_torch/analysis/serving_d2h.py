"""DLG206: device-to-host syncs on the port's per-token serving path (the
JAX package's analysis/serving_d2h.py, with a detector of its own for a
tensor's syncs).

A `.cpu()` in a save/load helper costs nothing; the same call reachable
from the scheduler's step body runs once per decode iteration across the
whole batch. On the card each such sync is a host gap between steps (the
batch step's host time) and a call that cannot sit inside a captured CUDA
graph. This pass enumerates WHICH syncs sit on that path.

Mechanism, as in the JAX audit: a leaf-name call graph over the runtime
tier (plus sampler.py), BFS-reachable from the per-token roots below; any
host sync whose line falls inside a reachable function is a DLG206. The
call graph matches by attribute/function leaf name, so
`self.engine.slot_decode_step(...)` reaches `Engine.slot_decode_step`
without type inference; over-approximation only ADDS findings.

The detector (`host_syncs`) replaces the JAX audit's DLG107 machinery,
which looks for JAX's syncs. It flags:

  * `.item()`, `.tolist()` on a value not known to live on the host, and
    `.cpu()` and `.numpy()` on any value (`.numpy()` right after a
    `.cpu()` is that one sync);
  * `int(t)`, `float(t)`, `bool(t)` and `np.asarray(t)` / `np.array(t)`
    where `t` is tensor-valued: a `torch.*` call, a tensor method's
    result, an index or arithmetic on one, or a local name assigned from
    one in the same function;
  * `torch.cuda.synchronize()` and any `<x>.synchronize()` (an Event's or
    a stream's): the host waits for the device.

Accepted sites go into analysis/baseline.json with a one-line
justification; the rule never passes silently.
"""

from __future__ import annotations

import ast
import os

from .findings import Finding, is_suppressed, parse_suppressions
from .race_lint import PACKAGE, _dotted, iter_package_files

# files the call graph covers (package-relative, posix)
SERVING_FILES = ("runtime/", "sampler.py")

# per-token serving roots: (file suffix, function leaf name). The
# scheduler step body is the continuous-batching inner loop; the legacy
# streaming generators are the apps/ serving path for single requests.
SERVING_ROOTS = (
    ("runtime/scheduler.py", "_step_body"),
    ("runtime/engine.py", "generate"),
    ("runtime/engine.py", "generate_lookup_stream"),
    ("runtime/engine.py", "generate_draft_sampled_stream"),
)

TRANSFER = "device-to-host transfer"
CONCRETIZE = "concretizes/syncs the value"
WAIT = "the host waits for the device"

# torch calls whose result is no tensor (or a host one)
_STATIC_TORCH = ("torch.cuda.", "torch.finfo", "torch.iinfo", "torch.device",
                 "torch.get_default_dtype", "torch.is_tensor",
                 "torch.is_floating_point", "torch.Size", "torch.dtype",
                 "torch.no_grad", "torch.inference_mode", "torch.Generator",
                 "torch.__version__")
# tensor methods and attributes whose result is host data
_HOST_METHODS = {"item", "tolist", "numpy", "cpu", "size", "dim", "numel",
                 "element_size", "data_ptr", "stride", "nelement",
                 "is_contiguous", "get_device", "storage_offset"}
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                 "requires_grad"}
# builtins whose result is host data
_HOST_CALLS = ("list", "tuple", "int", "float", "bool", "len", "range",
               "sorted", "dict", "set", "str")


_INF = float("inf")


def _ann(node: ast.AST | None) -> str:
    return ast.unparse(node) if node is not None else ""


class _Tensorish:
    """Which expressions of one function are (possibly) device tensors. A
    local name counts from the first line that binds it to a tensor (or to
    host data), so `tok = torch.as_tensor(np.asarray(tok))` reads the
    parameter, not the tensor; a parameter annotated `torch.Tensor` is a
    tensor, one annotated `np.ndarray` host data."""

    def __init__(self, fn: ast.AST):
        self.tensors: dict[str, float] = {}     # name -> first line bound
        self.host: dict[str, float] = {}
        a = fn.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs:
            ann = _ann(arg.annotation)
            if "torch.Tensor" in ann:
                self.tensors[arg.arg] = 0
            elif "np.ndarray" in ann or ann in ("int", "float", "bool", "list"):
                self.host[arg.arg] = 0
        assigns = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assign)),
                         key=lambda n: n.lineno)
        for _ in range(3):          # names fed by names: a short fixpoint
            for node in assigns:
                names = [t.id for t in node.targets if isinstance(t, ast.Name)]
                for t in node.targets:
                    if isinstance(t, ast.Tuple):
                        names += [e.id for e in t.elts if isinstance(e, ast.Name)]
                into = (self.tensors if self.expr(node.value, node.lineno)
                        else self.host if self.is_host(node.value, node.lineno)
                        else None)
                for n in names if into is not None else ():
                    into[n] = min(into.get(n, _INF), node.lineno)

    def is_host(self, node: ast.AST, line: float) -> bool:
        if isinstance(node, ast.Name):
            return self.host.get(node.id, _INF) < line
        if isinstance(node, (ast.Subscript, ast.Attribute)):
            return self.is_host(node.value, line)
        if isinstance(node, ast.Call):
            fn = _dotted(node.func)
            if fn.startswith(("np.", "numpy.")) or fn in _HOST_CALLS:
                return True
            if isinstance(node.func, ast.Attribute):
                return (node.func.attr in ("cpu", "numpy", "tolist", "fetch_logits")
                        or self.is_host(node.func.value, line))
        return isinstance(node, (ast.Constant, ast.List, ast.ListComp,
                                 ast.Tuple, ast.Dict))

    def expr(self, node: ast.AST | None, line: float) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return self.tensors.get(node.id, _INF) < line
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.expr(node.value, line)
        if isinstance(node, ast.Subscript):
            return self.expr(node.value, line)
        if isinstance(node, ast.BinOp):
            return self.expr(node.left, line) or self.expr(node.right, line)
        if isinstance(node, ast.UnaryOp):
            return self.expr(node.operand, line)
        if isinstance(node, ast.Call):
            fn = _dotted(node.func)
            if fn.startswith("torch."):
                return not fn.startswith(_STATIC_TORCH)
            if isinstance(node.func, ast.Attribute):
                if node.func.attr in _HOST_METHODS:
                    return False
                return self.expr(node.func.value, line)
        return False


def _sync_kind(node: ast.Call, taint: _Tensorish) -> str | None:
    fn, line = _dotted(node.func), node.lineno
    if fn == "torch.cuda.synchronize":
        return WAIT
    if isinstance(node.func, ast.Attribute):
        recv, attr = node.func.value, node.func.attr
        if attr == "synchronize":
            return WAIT
        if attr == "cpu":
            return TRANSFER
        if attr == "numpy":
            inner = (isinstance(recv, ast.Call) and isinstance(recv.func, ast.Attribute)
                     and recv.func.attr == "cpu")
            return None if inner or taint.is_host(recv, line) else TRANSFER
        if attr in ("item", "tolist") and not taint.is_host(recv, line):
            return CONCRETIZE if attr == "item" else TRANSFER
    if fn in ("int", "float", "bool") and len(node.args) == 1 \
            and taint.expr(node.args[0], line):
        return CONCRETIZE
    if fn in ("np.asarray", "np.array", "numpy.asarray", "numpy.array") \
            and node.args and taint.expr(node.args[0], line):
        return TRANSFER
    return None


def host_syncs(relpath: str, source: str) -> list[Finding]:
    """Every host sync of a tensor in `source`, one finding a call (rule
    DLG107, the JAX lint's id for a host-device boundary sync), inline
    `# dlgrind: ignore[...]` honoured."""
    tree = ast.parse(source, filename=relpath)
    found: dict[tuple, Finding] = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        taint = _Tensorish(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            kind = _sync_kind(node, taint)
            if kind is None:
                continue
            msg = f"`{ast.unparse(node)}` at the host-device boundary — {kind}"
            found.setdefault((node.lineno, msg), Finding(
                "DLG107", "info", relpath, node.lineno, msg))
    supp = parse_suppressions(source)
    return [f for _, f in sorted(found.items(), key=lambda kv: kv[0])
            if not is_suppressed(f, supp)]


def _functions_with_spans(tree: ast.Module):
    """(leaf name, lineno, end_lineno, called leaf names) per function."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                leaf = _dotted(sub.func).rsplit(".", 1)[-1]
                if leaf:
                    calls.add(leaf)
        out.append((node.name, node.lineno,
                    getattr(node, "end_lineno", node.lineno), calls))
    return out


def reachable_functions(pkg_root: str) -> tuple[dict, set]:
    """The serving tier's sources and the (file, function) pairs the roots
    reach by leaf name."""
    table: dict[str, list] = {}       # file -> [(name, lo, hi, calls)]
    by_name: dict[str, list] = {}     # leaf name -> [(file, lo, hi, calls)]
    sources: dict[str, str] = {}
    for rel in iter_package_files(pkg_root):
        scope = rel.split(PACKAGE, 1)[-1]
        if not (scope.startswith(SERVING_FILES[0])
                or scope == SERVING_FILES[1]):
            continue
        with open(os.path.join(pkg_root, rel), encoding="utf-8") as f:
            src = f.read()
        sources[rel] = src
        fns = _functions_with_spans(ast.parse(src, filename=rel))
        table[rel] = fns
        for name, lo, hi, calls in fns:
            by_name.setdefault(name, []).append((rel, lo, hi, calls))
    reachable: set[tuple[str, str]] = set()
    frontier: list[tuple[str, str, set]] = []
    for root_file, root_fn in SERVING_ROOTS:
        for rel, fns in table.items():
            if rel.endswith(root_file):
                frontier += [(rel, name, calls) for name, _, _, calls in fns
                             if name == root_fn]
    while frontier:
        rel, name, calls = frontier.pop()
        if (rel, name) in reachable:
            continue
        reachable.add((rel, name))
        for callee in calls:
            for crel, _, _, ccalls in by_name.get(callee, []):
                if (crel, callee) not in reachable:
                    frontier.append((crel, callee, ccalls))
    spans = {rel: [(lo, hi) for (name, lo, hi, _) in fns if (rel, name) in reachable]
             for rel, fns in table.items()}
    return {rel: (sources[rel], spans[rel]) for rel in table}, reachable


def audit_serving_path(pkg_root: str, prefix: str = "") -> list[Finding]:
    files, _ = reachable_functions(pkg_root)
    findings: list[Finding] = []
    for rel, (src, spans) in files.items():
        if not spans:
            continue
        for f in host_syncs(prefix + rel, src):
            if any(lo <= f.line <= hi for lo, hi in spans):
                findings.append(Finding(
                    "DLG206", "info", f.file, f.line,
                    f"{f.message} — on the per-token serving path (runs "
                    "every decode iteration)"))
    return findings
