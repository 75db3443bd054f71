"""Lock-discipline lint (dlrace, DLG3xx) over the port's host runtime: a
copy of the JAX package's analysis/race_lint.py, scoped to the port and
with the port's own blocking calls.

The serving stack is a dozen cooperating threads — scheduler step loop,
supervisor watchdog + rebuild, router monitor, worker pump, tracer sink,
profiler capture, the ranks' control channel — and the dominant residual
bug class is the host-side race found only by review: the half-open probe
leak (a bare `acquire()` stranded by an exception), the
deque-mutated-during-iteration scan crash, the close/submit TOCTOU, the
unjoined `_rebuild` thread segfaulting interpreter teardown, and on the
card a profiler capture that hung behind a device wait and a borrow that
deadlocked against a graph capture. These rules encode that reviewer's
eye:

  DLG301  write (assignment, aug-assign, item-store, or mutating method
          call) to a `# dlrace: guarded-by(<lock>)` field without the
          guard held
  DLG302  blocking call (socket send/recv, subprocess, time.sleep,
          thread .join, a device wait — torch.cuda.synchronize or an
          Event's — a CUDA graph capture, a torch.distributed collective)
          while holding a declared guard lock — the watchdog-vs-capture
          stall shape
  DLG303  bare `.acquire()` not paired with try/finally release and not
          a context manager — an exception strands the lock forever
  DLG304  thread stored on `self` and started, but never `.join()`ed on
          any close/shutdown path — teardown runs callbacks into a
          half-destroyed interpreter
  DLG305  iteration (for / comprehension / list()/sorted()/.items()...)
          over a guarded container field outside its guard — mutation
          during iteration raises at runtime
  DLG306  `time.time()` used for interval arithmetic — wall clock jumps
          under NTP slew; deadlines and durations take perf_counter()

Discipline model, deliberately lightweight and intraprocedural:

* Shared state is DECLARED, not inferred: an attribute assignment whose
  line carries `# dlrace: guarded-by(self._lock)` marks that field as
  owned by that lock for the whole class. Only declared fields get
  DLG301/DLG305 checks — the annotation is the reviewer's statement of
  intent, the lint enforces it.
* Per-method lock-held sets come from `with self._lock:` blocks,
  linear `acquire()`/`release()` pairs within a statement list, and the
  `_locked`-suffix naming convention (a `*_locked` method asserts its
  caller holds the class guards).
* Accesses are `self.<field>` only: cross-object lock-free peeks (a
  router reading `sched._queue`) are design decisions documented at the
  reading site, not races this pass can judge.
* `__init__`/`__post_init__` are exempt from DLG301/DLG305 — the object
  is not shared
  during construction.
* DLG302 fires only while a DECLARED guard lock is held: dedicated I/O
  mutexes (a per-socket send lock exists precisely to serialize a
  blocking send) are deliberately not annotated and never trip it.
* Locals-only threads (`t = Thread(...); t.start()`) are fire-and-forget
  by construction and out of DLG304 scope; the rule tracks instance
  attributes, the shape the historical segfault took.

False negatives are acceptable, false positives are not (every rule has
a clean fixture). Deliberate exceptions — GIL-atomic deque appends on
the submit hot path, lock-free heartbeat floats — are baselined with a
one-line justification, never bare-suppressed.
"""

from __future__ import annotations

import ast
import os
import re

from .findings import Finding, is_suppressed, parse_suppressions

# modules the lock-discipline pass runs over (package-relative, posix);
# runtime/ holds graphs.py (the device gate) with the rest
RACE_SCOPE = ("runtime/", "apps/", "parallel/multihost.py",
              "parallel/control.py")
PACKAGE = "distributed_llama_tpu_torch/"

# `self._queue = deque()  # dlrace: guarded-by(self._mutex)`
GUARD_RE = re.compile(
    r"#\s*dlrace:\s*guarded-by\(\s*(?:self\.)?(?P<lock>[A-Za-z_]\w*)\s*\)")
# `def _step_body(self):  # dlrace: holds(self._mutex)` — the def-line
# form of the `_locked`-suffix convention: the caller owns the lock.
# For helpers whose name can't carry the suffix (public API contracts,
# roots other passes reference by name).
HOLDS_RE = re.compile(
    r"#\s*dlrace:\s*holds\(\s*(?:self\.)?(?P<lock>[A-Za-z_]\w*)\s*\)")

# receivers that look like locks even without an annotation (DLG303)
_LOCKISH_RE = re.compile(r"(?:^|_)(?:lock|mutex|sem|rlock)\b|_lock$|_mutex$",
                         re.IGNORECASE)

# container constructors: a guarded field built from one of these gets
# DLG305 iteration checks (scalar guarded fields don't — reading a float
# outside the lock is a staleness question, not a crash)
_CONTAINER_CTORS = {"deque", "dict", "list", "set", "OrderedDict",
                    "defaultdict", "Counter"}
# mutating methods on containers — a call through `self.<field>.<m>(...)`
# is a write for DLG301
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "pop", "popleft", "popitem", "remove", "discard", "clear",
             "add", "update", "setdefault", "move_to_end", "rotate"}
# consuming calls: `list(self._q)` / `sorted(self._m)` iterate the operand
_ITER_CONSUMERS = {"list", "tuple", "set", "frozenset", "sorted", "sum",
                   "max", "min", "any", "all", "dict"}
# `self._m.items()` etc. iterate (or hand out an iterator over) the field
_ITER_METHODS = {"items", "values", "keys", "copy"}

# DLG302 blocking sinks while a guard is held: the JAX lint's (jax.jit
# and block_until_ready stay, harmless here), then the port's own — a
# device wait, a CUDA graph capture, a torch.distributed collective
_BLOCKING_DOTTED = {"time.sleep", "jax.jit", "subprocess.run",
                    "subprocess.call", "subprocess.check_call",
                    "subprocess.check_output", "subprocess.Popen",
                    "socket.create_connection", "socket.create_server",
                    "torch.cuda.synchronize", "torch.cuda.graph"}
_BLOCKING_LEAVES = {"recv", "recv_into", "sendall", "accept", "connect",
                    "block_until_ready", "wait_ready", "spawn",
                    "synchronize", "capture_begin", "capture_end"}
# torch.distributed's collectives, called as `dist.<name>` or
# `torch.distributed.<name>`
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                "all_gather_object", "reduce_scatter",
                "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
                "broadcast", "broadcast_object_list", "reduce", "gather",
                "scatter", "barrier", "send", "recv", "monitored_barrier"}
_COLLECTIVE_MODULES = ("dist", "torch.distributed")
# the repo's framed socket codec helpers — module-level functions
_BLOCKING_NAMES = {"_send_frame", "_recv_frame", "send_frame", "recv_frame"}

_CLOSE_METHOD_RE = re.compile(
    r"^(close|shutdown|stop|terminate|join|aclose|__exit__|__del__)")


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _norm_lock(name: str) -> str:
    """Normalize a lock reference for held-set membership: `self._lock`
    and `_lock` are the same guard."""
    return name[5:] if name.startswith("self.") else name


def _self_field(node: ast.AST) -> str | None:
    """'X' when node is exactly `self.X`, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ClassModel:
    """Per-class discipline facts collected in pass A."""

    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.guards: dict[str, str] = {}       # field -> normalized lock
        self.containers: set[str] = set()      # guarded container fields
        self.threads: dict[str, int] = {}      # thread attr -> decl line
        self.joined: set[str] = set()          # thread attrs joined on a
        #                                        close/shutdown path

    def guard_locks(self) -> set[str]:
        return set(self.guards.values())


class RaceLinter:
    def __init__(self, relpath: str, source: str):
        self.relpath = relpath
        self.source = source
        self.tree = ast.parse(source, filename=relpath)
        self.findings: list[Finding] = []
        # line -> lock name, from guarded-by / holds comments
        self.guard_lines: dict[int, str] = {}
        self.holds_lines: dict[int, str] = {}
        for i, text in enumerate(source.splitlines(), start=1):
            m = GUARD_RE.search(text)
            if m:
                self.guard_lines[i] = _norm_lock(m.group("lock"))
            m = HOLDS_RE.search(text)
            if m:
                self.holds_lines[i] = _norm_lock(m.group("lock"))

    def add(self, rule: str, severity: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(rule, severity, self.relpath,
                                     getattr(node, "lineno", 0), msg))

    def run(self) -> list[Finding]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                model = self._collect(node)
                self._check_class(node, model)
        # DLG306 also applies to module-level functions (no class state)
        for stmt in self.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._lint_wall_clock(stmt)
        supp = parse_suppressions(self.source)
        out, seen = [], set()
        for f in self.findings:
            if is_suppressed(f, supp):
                continue
            if (f.rule, f.line) in seen:
                continue
            seen.add((f.rule, f.line))
            out.append(f)
        return out

    # -- pass A: collect the class discipline model ------------------------

    def _methods(self, cls: ast.ClassDef):
        return [n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    def _collect(self, cls: ast.ClassDef) -> _ClassModel:
        model = _ClassModel(cls)
        for meth in self._methods(cls):
            for node in ast.walk(meth):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    field = _self_field(tgt)
                    if field is None:
                        continue
                    lock = self._guard_for(node)
                    if lock is not None:
                        model.guards[field] = lock
                        if self._is_container(node.value):
                            model.containers.add(field)
                    if self._is_thread_ctor(node.value):
                        model.threads.setdefault(field, node.lineno)
        # joins that count: inside a close/shutdown-shaped method, either
        # directly (`self._t.join()`) or through a local snapshot taken
        # under the lock (`t = self._t` ... `t.join()` — the idiomatic
        # shape when the attr itself is guarded)
        for meth in self._methods(cls):
            if not _CLOSE_METHOD_RE.match(meth.name):
                continue
            aliases: dict[str, str] = {}
            for node in ast.walk(meth):
                if isinstance(node, ast.Assign):
                    field = _self_field(node.value)
                    if field is not None:
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                aliases[tgt.id] = field
            for node in ast.walk(meth):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "join"):
                    field = _self_field(node.func.value)
                    if field is None and isinstance(node.func.value,
                                                    ast.Name):
                        field = aliases.get(node.func.value.id)
                    if field:
                        model.joined.add(field)
        return model

    def _guard_for(self, stmt: ast.AST) -> str | None:
        end = getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno
        for line in range(stmt.lineno, end + 1):
            if line in self.guard_lines:
                return self.guard_lines[line]
        return None

    def _is_container(self, value: ast.AST | None) -> bool:
        if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)):
            return True
        if isinstance(value, ast.Call):
            return _dotted(value.func).rsplit(".", 1)[-1] in _CONTAINER_CTORS
        return False

    def _is_thread_ctor(self, value: ast.AST | None) -> bool:
        if not isinstance(value, ast.Call):
            return False
        return _dotted(value.func).rsplit(".", 1)[-1] == "Thread"

    # -- pass B: per-method checks -----------------------------------------

    def _check_class(self, cls: ast.ClassDef, model: _ClassModel) -> None:
        # DLG304: every instance-attribute thread needs a join on a
        # close/shutdown path (fire-and-forget locals are out of scope)
        for field, line in sorted(model.threads.items()):
            if field not in model.joined:
                self.findings.append(Finding(
                    "DLG304", "warning", self.relpath, line,
                    f"thread `self.{field}` in `{cls.name}` is never "
                    "joined on a close/shutdown path — interpreter "
                    "teardown can run its callback into freed state"))
        for meth in self._methods(cls):
            self._meth_name = f"{cls.name}.{meth.name}"
            held: set[str] = set()
            if meth.name.endswith("_locked"):
                # convention: the caller holds the class guards
                held = model.guard_locks()
            held |= self._declared_holds(meth)
            self._scan(meth.body, held, set(), model, meth)
            self._lint_wall_clock(meth)
        self._meth_name = "?"

    def _scan(self, stmts: list[ast.stmt], held: set[str],
              finally_releases: set[str], model: _ClassModel, meth) -> None:
        cur = set(held)
        for idx, stmt in enumerate(stmts):
            acq = self._acquire_target(stmt)
            if acq is not None:
                nxt = stmts[idx + 1] if idx + 1 < len(stmts) else None
                protected = (acq in finally_releases
                             or (isinstance(nxt, ast.Try)
                                 and self._releases(nxt.finalbody, acq)))
                if not protected:
                    self.add("DLG303", "error", stmt,
                             f"bare `{acq}.acquire()` without try/finally "
                             "release — an exception before the release "
                             "strands the lock (use `with` or wrap in "
                             "try/finally)")
                cur.add(acq)
                continue
            rel = self._release_target(stmt)
            if rel is not None:
                cur.discard(rel)
                continue
            self._check_stmt(stmt, cur, model, meth)
            # recursion with the updated held set
            if isinstance(stmt, ast.With):
                locks = set()
                for item in stmt.items:
                    name = _dotted(item.context_expr)
                    if not name and isinstance(item.context_expr, ast.Call):
                        name = _dotted(item.context_expr.func)
                    norm = _norm_lock(name)
                    if norm and (norm in model.guard_locks()
                                 or _LOCKISH_RE.search(norm)):
                        locks.add(norm)
                self._scan(stmt.body, cur | locks, finally_releases,
                           model, meth)
            elif isinstance(stmt, ast.Try):
                fin = self._lockish_released(stmt.finalbody)
                self._scan(stmt.body, cur, finally_releases | fin,
                           model, meth)
                for h in stmt.handlers:
                    self._scan(h.body, cur, finally_releases | fin,
                               model, meth)
                self._scan(stmt.orelse, cur, finally_releases | fin,
                           model, meth)
                self._scan(stmt.finalbody, cur, finally_releases,
                           model, meth)
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan(stmt.body, cur, finally_releases, model, meth)
                self._scan(stmt.orelse, cur, finally_releases, model, meth)
            elif isinstance(stmt, ast.For):
                self._scan(stmt.body, cur, finally_releases, model, meth)
                self._scan(stmt.orelse, cur, finally_releases, model, meth)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def runs LATER (usually on another thread) —
                # the enclosing held set does not apply
                inner = (model.guard_locks()
                         if stmt.name.endswith("_locked") else set())
                inner |= self._declared_holds(stmt)
                self._scan(stmt.body, inner, set(), model, meth)

    def _acquire_target(self, stmt: ast.stmt) -> str | None:
        value = None
        if isinstance(stmt, ast.Expr):
            value = stmt.value
        elif isinstance(stmt, ast.Assign):
            value = stmt.value
        if (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr == "acquire"):
            name = _norm_lock(_dotted(value.func.value))
            if name and (_LOCKISH_RE.search(name) or name in
                         self._all_guard_locks()):
                return name
        return None

    def _release_target(self, stmt: ast.stmt) -> str | None:
        if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr == "release"):
            return _norm_lock(_dotted(stmt.value.func.value)) or None
        return None

    def _releases(self, stmts: list[ast.stmt], lock: str) -> bool:
        for node in (n for s in stmts for n in ast.walk(s)):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "release"
                    and _norm_lock(_dotted(node.func.value)) == lock):
                return True
        return False

    def _lockish_released(self, stmts: list[ast.stmt]) -> set[str]:
        out = set()
        for node in (n for s in stmts for n in ast.walk(s)):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "release"):
                name = _norm_lock(_dotted(node.func.value))
                if name:
                    out.add(name)
        return out

    def _all_guard_locks(self) -> set[str]:
        return set(self.guard_lines.values())

    def _declared_holds(self, fn) -> set[str]:
        """Locks a `# dlrace: holds(...)` comment on the def line (or the
        signature's continuation lines) declares the caller owns."""
        first_body = fn.body[0].lineno if fn.body else fn.lineno + 1
        out = set()
        for line in range(fn.lineno, max(first_body, fn.lineno + 1)):
            if line in self.holds_lines:
                out.add(self.holds_lines[line])
        return out

    # -- per-statement sinks ----------------------------------------------

    def _stmt_exprs(self, stmt):
        for field, value in ast.iter_fields(stmt):
            if field in ("body", "orelse", "finalbody", "handlers"):
                continue
            for v in (value if isinstance(value, list) else [value]):
                if isinstance(v, ast.AST):
                    yield from ast.walk(v)

    def _check_stmt(self, stmt, held: set[str], model: _ClassModel,
                    meth) -> None:
        in_init = meth.name in ("__init__", "__post_init__")
        # DLG301: assignment-shaped writes
        if not in_init:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = stmt.targets
            elif isinstance(stmt, ast.AugAssign):
                targets = [stmt.target]
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets = [stmt.target]
            for tgt in targets:
                self._check_write_target(tgt, stmt, held, model)
        # expression-level sinks
        for node in self._stmt_exprs(stmt):
            if isinstance(node, ast.Call):
                if not in_init:
                    self._check_mutator_call(node, held, model)
                    self._check_iter_call(node, held, model)
                self._check_blocking_call(node, held, model)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp, ast.DictComp)):
                if not in_init:
                    for gen in node.generators:
                        self._check_iter_expr(gen.iter, node, held, model)
        # DLG305: for-loop over a guarded container
        if isinstance(stmt, ast.For) and not in_init:
            self._check_iter_expr(stmt.iter, stmt, held, model)

    def _guarded_field_expr(self, node: ast.AST,
                            model: _ClassModel) -> str | None:
        """'X' when node reads guarded container `self.X` (directly or via
        .items()/.values()/.keys()/.copy())."""
        field = _self_field(node)
        if field in model.containers:
            return field
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _ITER_METHODS):
            field = _self_field(node.func.value)
            if field in model.containers:
                return field
        return None

    def _check_write_target(self, tgt, stmt, held, model) -> None:
        field = _self_field(tgt)
        if field is None and isinstance(tgt, ast.Subscript):
            field = _self_field(tgt.value)
        if field is None and isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._check_write_target(el, stmt, held, model)
            return
        if field in model.guards and model.guards[field] not in held:
            self.add("DLG301", "error", stmt,
                     f"unguarded write to `self.{field}` (guarded-by "
                     f"`{model.guards[field]}`) in `{self._meth_name}`")

    def _check_mutator_call(self, node: ast.Call, held, model) -> None:
        if not isinstance(node.func, ast.Attribute):
            return
        if node.func.attr not in _MUTATORS:
            return
        field = _self_field(node.func.value)
        if field in model.guards and model.guards[field] not in held:
            self.add("DLG301", "error", node,
                     f"unguarded `self.{field}.{node.func.attr}()` "
                     f"(guarded-by `{model.guards[field]}`) in "
                     f"`{self._meth_name}`")

    def _check_iter_call(self, node: ast.Call, held, model) -> None:
        # list(self._q) / sorted(self._m.items()) / self._m.items()
        field = None
        leaf = _dotted(node.func).rsplit(".", 1)[-1]
        if leaf in _ITER_CONSUMERS and node.args:
            field = self._guarded_field_expr(node.args[0], model)
        if field is None:
            field = self._guarded_field_expr(node, model) \
                if isinstance(node.func, ast.Attribute) else None
        if field and model.guards[field] not in held:
            self.add("DLG305", "error", node,
                     f"iteration over guarded container `self.{field}` "
                     f"outside `{model.guards[field]}` in "
                     f"`{self._meth_name}` — concurrent mutation raises "
                     "mid-iteration")

    def _check_iter_expr(self, it: ast.AST, anchor, held, model) -> None:
        field = self._guarded_field_expr(it, model)
        if field and model.guards[field] not in held:
            self.add("DLG305", "error", anchor,
                     f"iteration over guarded container `self.{field}` "
                     f"outside `{model.guards[field]}` in "
                     f"`{self._meth_name}` — concurrent mutation raises "
                     "mid-iteration")

    def _check_blocking_call(self, node: ast.Call, held,
                             model: _ClassModel) -> None:
        # only while a DECLARED guard is held — dedicated I/O mutexes are
        # deliberately unannotated and never trip this rule
        guard_held = held & model.guard_locks()
        if not guard_held:
            return
        fn = _dotted(node.func)
        leaf = fn.rsplit(".", 1)[-1]
        blocking = (fn in _BLOCKING_DOTTED
                    or fn in _BLOCKING_NAMES
                    or (isinstance(node.func, ast.Attribute)
                        and leaf in _BLOCKING_LEAVES)
                    or (leaf in _COLLECTIVES
                        and fn.rsplit(".", 1)[0] in _COLLECTIVE_MODULES))
        if not blocking and isinstance(node.func, ast.Attribute) \
                and leaf == "join":
            # .join() is blocking only on thread values; str.join is not
            field = _self_field(node.func.value)
            blocking = field in model.threads
        if blocking:
            lock = sorted(guard_held)[0]
            self.add("DLG302", "warning", node,
                     f"blocking call `{fn}` while holding `{lock}` — "
                     "every reader of that guard stalls behind it (move "
                     "the slow work outside the critical section)")

    # -- DLG306: wall clock in interval arithmetic -------------------------

    def _lint_wall_clock(self, fn) -> None:
        wall_names: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                if _dotted(node.value.func) == "time.time":
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            wall_names.add(tgt.id)

        def wallish(n: ast.AST, direct_only: bool = False) -> bool:
            if isinstance(n, ast.Call) and _dotted(n.func) == "time.time":
                return True
            if not direct_only and isinstance(n, ast.Name):
                return n.id in wall_names
            return False

        for node in ast.walk(fn):
            if not isinstance(node, ast.BinOp):
                continue
            if isinstance(node.op, ast.Sub):
                hit = wallish(node.left) or wallish(node.right)
            elif isinstance(node.op, ast.Add):
                # deadline construction: `time.time() + timeout`
                hit = wallish(node.left, True) or wallish(node.right, True)
            else:
                continue
            if hit:
                self.add("DLG306", "warning", node,
                         "`time.time()` in interval arithmetic "
                         f"(`{ast.unparse(node)}`) — wall clock slews "
                         "under NTP; use time.perf_counter() or "
                         "time.monotonic() for durations/deadlines")

    # the method currently being scanned, for finding messages (stable
    # per-site keys name the method, never the line)
    _meth_name = "?"


def race_lint_source(relpath: str, source: str) -> list[Finding]:
    return RaceLinter(relpath, source).run()


def in_race_scope(relpath: str) -> bool:
    scope = relpath.split(PACKAGE, 1)[-1]
    return any(scope == m or (m.endswith("/") and scope.startswith(m))
               for m in RACE_SCOPE)


def iter_package_files(pkg_root: str) -> list[str]:
    """All .py files under the package dir, POSIX-style relative paths,
    sorted (the JAX package's ast_lint.iter_package_files): the scope rules
    match with '/', and Finding.file is a baseline key that must be
    identical across platforms."""
    out = []
    for dirpath, _, files in os.walk(pkg_root):
        for name in files:
            if name.endswith(".py"):
                full = os.path.join(dirpath, name)
                out.append(os.path.relpath(full, pkg_root).replace(os.sep, "/"))
    return sorted(out)


def race_lint_package(pkg_root: str, prefix: str = "") -> list[Finding]:
    findings: list[Finding] = []
    for rel in iter_package_files(pkg_root):
        if not in_race_scope(rel):
            continue
        with open(os.path.join(pkg_root, rel), encoding="utf-8") as f:
            src = f.read()
        findings.extend(race_lint_source(prefix + rel, src))
    return findings
