"""The port's analysis (distributed_llama_tpu_torch/analysis) held against
the JAX package's: dlrace gives the JAX linter's (rule, line, message) on
every synthetic source of tests/test_race_lint.py, the hygiene rules agree,
the sync detector finds each torch sink and not its clean twin, the port's
gate is clean with every baseline entry justified, DLG206 pins the port's
per-token syncs by name, the CLI's exit codes are 0, 1 and 2, and each
guard declaration carried into the port trips on a planted unguarded
write.
"""

import ast
import json
import pathlib
import re

import pytest

from distributed_llama_tpu.analysis import __main__ as jax_main
from distributed_llama_tpu.analysis.race_lint import race_lint_source as jax_lint
from distributed_llama_tpu_torch.analysis import __main__ as cli
from distributed_llama_tpu_torch.analysis.findings import (load_baseline,
                                                           split_by_baseline,
                                                           unjustified_keys)
from distributed_llama_tpu_torch.analysis.race_lint import (GUARD_RE, RACE_SCOPE,
                                                            in_race_scope,
                                                            race_lint_source)
from distributed_llama_tpu_torch.analysis.serving_d2h import (audit_serving_path,
                                                              host_syncs)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "distributed_llama_tpu_torch"
FIXTURES = ROOT / "tests" / "fixtures" / "race_lint"

_HEAD = ("import threading\n"
         "from collections import deque\n"
         "class S:\n"
         "    def __init__(self):\n"
         "        self._mu = threading.Lock()\n"
         "        self._q = deque()  # dlrace: guarded-by(self._mu)\n")
# the inline sources of tests/test_race_lint.py (holds/_locked, the
# suppression and its narrowed twin, nested defs)
INLINE = {
    "holds": _HEAD + ("    def _pump_locked(self):\n"
                      "        self._q.append(1)\n"
                      "    def _drain(self):  # dlrace: holds(self._mu)\n"
                      "        self._q.popleft()\n"
                      "    def broken(self):\n"
                      "        self._q.append(2)\n"),
    "suppressed": _HEAD + ("    def hot(self):\n"
                           "        self._q.append(1)  # dlrace: ignore[DLG301]\n"),
    "narrowed": _HEAD + ("    def hot(self):\n"
                         "        self._q.append(1)  # dlrace: ignore[DLG305]\n"),
    "nested": _HEAD + ("    def arm(self):\n"
                       "        with self._mu:\n"
                       "            def cb():\n"
                       "                self._q.append(1)\n"
                       "            return cb\n"),
}


def _triples(findings):
    return [(f.rule, f.line, f.message) for f in findings]


@pytest.mark.parametrize("name", sorted(p.name for p in FIXTURES.glob("*.py")))
def test_fixture_corpus_gives_the_jax_linters_findings(name):
    src = (FIXTURES / name).read_text()
    rel = f"tests/fixtures/race_lint/{name}"
    mine = race_lint_source(rel, src)
    assert _triples(mine) == _triples(jax_lint(rel, src))
    assert bool(mine) == name.endswith("_bad.py")


@pytest.mark.parametrize("name", sorted(INLINE))
def test_inline_sources_give_the_jax_linters_findings(name):
    mine = race_lint_source("x.py", INLINE[name])
    assert _triples(mine) == _triples(jax_lint("x.py", INLINE[name]))
    assert [f.rule for f in mine] == {"holds": ["DLG301"], "suppressed": [],
                                      "narrowed": ["DLG301"], "nested": ["DLG301"]}[name]


@pytest.mark.parametrize("baseline", [
    {"findings": ["DLG301|gone.py|msg"], "justifications": {"DLG301|gone.py|msg": "why"}},
    {"findings": ["DLG301|a.py|m"], "justifications": {"DLG301|a.py|m": "TODO: justify"}},
    {"findings": ["DLG301|a.py|m", "DLG301|a.py|m"], "justifications": {}},
], ids=["stale", "todo", "counted"])
def test_hygiene_rules_give_the_jax_findings(baseline):
    from distributed_llama_tpu.analysis.findings import Finding as JaxFinding

    mine = cli.hygiene_findings([], baseline)
    theirs = jax_main.hygiene_findings([], baseline)
    assert _triples(mine) == _triples(theirs)
    assert {f.rule for f in mine} >= {"DLG108"}
    one = [JaxFinding("DLG301", "error", "a.py", 3, "m")]
    assert _triples(cli.hygiene_findings(one, baseline)) == \
        _triples(jax_main.hygiene_findings(one, baseline))


def test_race_scope_is_the_ports_own():
    assert in_race_scope("distributed_llama_tpu_torch/runtime/scheduler.py")
    assert in_race_scope("distributed_llama_tpu_torch/runtime/graphs.py")
    assert in_race_scope("distributed_llama_tpu_torch/apps/api_server.py")
    assert in_race_scope("distributed_llama_tpu_torch/parallel/multihost.py")
    assert in_race_scope("distributed_llama_tpu_torch/parallel/control.py")
    assert not in_race_scope("distributed_llama_tpu_torch/parallel/collectives.py")
    assert not in_race_scope("distributed_llama_tpu_torch/ops/cuda_q40.py")
    assert sorted(RACE_SCOPE) == ["apps/", "parallel/control.py",
                                  "parallel/multihost.py", "runtime/"]


BLOCKING = {
    "torch.cuda.synchronize()": "torch.cuda.synchronize",
    "self._ev.synchronize()": "self._ev.synchronize",
    "g.capture_begin()": "g.capture_begin",
    "dist.all_reduce(t)": "dist.all_reduce",
    "torch.distributed.broadcast(t, 0)": "torch.distributed.broadcast",
    "dist.barrier()": "dist.barrier",
}


@pytest.mark.parametrize("call", sorted(BLOCKING))
def test_dlg302_flags_the_ports_blocking_calls_under_a_guard(call):
    src = _HEAD + ("    def bad(self, t, g):\n"
                   "        with self._mu:\n"
                   f"            {call}\n"
                   "    def good(self, t, g):\n"
                   "        with self._mu:\n"
                   "            self._q.append(1)\n"
                   f"        {call}\n")
    fs = race_lint_source("x.py", src)
    assert [f.rule for f in fs] == ["DLG302"] and fs[0].line == 9
    assert f"`{BLOCKING[call]}`" in fs[0].message
    cap = _HEAD + ("    def bad(self, g):\n"
                   "        with self._mu:\n"
                   "            with torch.cuda.graph(g):\n"
                   "                pass\n")
    assert [f.rule for f in race_lint_source("x.py", cap)] == ["DLG302"]


SINKS = {
    "t.item()": ("x = torch.ones(3)\n    return x.sum().item()",
                 "x = np.ones(3)\n    return x.sum().item()"),
    "t.tolist()": ("x = torch.arange(3)\n    return x.tolist()",
                   "x = np.arange(3)\n    return x.tolist()"),
    "t.cpu()": ("return logits.float().cpu()", "return logits.float()"),
    "t.numpy()": ("return logits.numpy()", "return np.zeros(3).numpy()"),
    "int(t)": ("n = torch.argmax(logits)\n    return int(n)",
               "n = len(logits)\n    return int(n)"),
    "float(t)": ("return float(logits.max())", "return float(logits.shape[0])"),
    "bool(t)": ("done = torch.any(logits > 0)\n    return bool(done)",
                "done = logits.shape[0] > 0\n    return bool(done)"),
    "np.asarray(t)": ("x = torch.zeros(3)\n    return np.asarray(x)",
                      "x = [0, 1]\n    return np.asarray(x)"),
    "torch.cuda.synchronize()": ("torch.cuda.synchronize()", "torch.cuda.is_available()"),
    "Event.synchronize()": ("ev.synchronize()", "ev.record()"),
}


@pytest.mark.parametrize("sink", sorted(SINKS))
def test_sync_detector_finds_each_torch_sink_and_not_its_twin(sink):
    bad, clean = SINKS[sink]
    head = "def f(logits: torch.Tensor, ev):\n    "
    found = host_syncs("x.py", head + bad + "\n")
    assert len(found) == 1 and found[0].rule == "DLG107", found
    assert "at the host-device boundary" in found[0].message
    assert host_syncs("x.py", head + clean + "\n") == []
    # an inline suppression silences it
    lines = (head + bad).split("\n")
    lines[found[0].line - 1] += "  # dlgrind: ignore[DLG107]"
    assert host_syncs("x.py", "\n".join(lines) + "\n") == []


def test_sync_detector_reads_the_parameter_before_its_rebinding():
    src = ("def f(tok):\n"
           "    tok = torch.as_tensor(np.asarray(tok, np.int64))\n"
           "    return np.asarray(tok)\n")
    assert [f.line for f in host_syncs("x.py", src)] == [3]


def test_the_ports_gate_is_clean_and_every_baseline_entry_justified():
    baseline = load_baseline(cli.DEFAULT_BASELINE)
    assert baseline["findings"] and unjustified_keys(baseline) == []
    findings = cli.gather_findings()
    new, accepted = split_by_baseline(findings, baseline)
    new.extend(cli.hygiene_findings(findings, baseline))
    assert not new, "\n".join(f"{f.anchor()}: {f.rule} {f.message}" for f in new)
    assert len(accepted) == len(baseline["findings"])


def test_no_bare_dlrace_suppressions_in_the_ports_race_scope():
    bare = re.compile(r"#\s*dl(?:grind|race):\s*ignore(?!\[)")
    for p in PORT.rglob("*.py"):
        rel = p.relative_to(ROOT).as_posix()
        if in_race_scope(rel):
            assert not bare.search(p.read_text()), rel


# the per-token serving path's syncs: (file, call) -> sites
SERVING_SYNCS = {
    ("draft.py", "out.cpu()"): 1,
    ("draft.py", "step().cpu()"): 1,
    ("draft.py", "g.out.cpu()"): 1,
    ("engine.py", "logits.float().cpu()"): 1,
    ("engine.py", "self._gather_rows(toks).cpu()"): 1,
    ("engine.py", "self._gather_rows(x).cpu()"): 1,
    ("engine.py", "self._gather_rows(greedy).cpu()"): 2,
    ("graphs.py", "torch.cuda.synchronize()"): 2,
}


def test_dlg206_pins_the_ports_per_token_syncs_by_name():
    fs = audit_serving_path(str(PORT), prefix="distributed_llama_tpu_torch/")
    got: dict = {}
    for f in fs:
        assert f.rule == "DLG206" and "per-token serving path" in f.message
        key = (f.file.rsplit("/", 1)[-1], f.message.split("`")[1])
        got[key] = got.get(key, 0) + 1
    assert got == SERVING_SYNCS
    keys = set(load_baseline(cli.DEFAULT_BASELINE)["findings"])
    assert all(f.key() in keys for f in fs)


def test_cli_exit_codes(tmp_path, capsys):
    assert cli.run(["--check"]) == 0
    assert "0 finding(s), 19 baselined" in capsys.readouterr().out
    empty = tmp_path / "empty.json"
    assert cli.run(["--check", "--baseline", str(empty)]) == 1
    assert cli.run(["--baseline", str(empty)]) == 0          # report mode
    out = capsys.readouterr().out
    assert "DLG301" in out and "DLG206" in out
    assert cli.run(["--check", "--format", "json", "--baseline", str(empty)]) == 1
    assert json.loads(capsys.readouterr().out)[0]["rule"]
    assert cli.run(["--format", "github", "--baseline", str(empty)]) == 0
    assert capsys.readouterr().out.startswith("::")
    broken = tmp_path / "pkg" / "runtime"
    broken.mkdir(parents=True)
    (broken / "bad.py").write_text("def f(:\n")
    assert cli.run(["--check"], pkg_dir=str(tmp_path / "pkg")) == 2
    (tmp_path / "bad.json").write_text("{not json")
    assert cli.run(["--check", "--baseline", str(tmp_path / "bad.json")]) == 2
    upd = tmp_path / "upd.json"
    assert cli.run(["--update-baseline", "--baseline", str(upd)]) == 0
    assert unjustified_keys(load_baseline(str(upd)))     # TODO placeholders
    assert cli.run(["--check", "--baseline", str(upd)]) == 1    # DLG109


def _declarations():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT).as_posix()
        if "analysis/" in rel:
            continue
        lines = p.read_text().splitlines()
        for i, text in enumerate(lines, start=1):
            m = GUARD_RE.search(text)
            if m:
                out.append((rel, i))
    return out


DECLARED = _declarations()


def test_the_jax_packages_guard_declarations_are_in_the_port():
    counts: dict = {}
    for rel, _ in DECLARED:
        counts[rel] = counts.get(rel, 0) + 1
    for rel, n in {"runtime/resilience.py": 6, "runtime/stats.py": 6,
                   "runtime/trace.py": 7, "runtime/profiler.py": 6,
                   "runtime/scheduler.py": 4, "parallel/multihost.py": 2,
                   "runtime/faults.py": 1, "runtime/graphs.py": 6}.items():
        assert counts.get(rel) == n, (rel, counts.get(rel))
    holds = {rel: (PORT / rel).read_text().count("# dlrace: holds(")
             for rel in ("runtime/trace.py", "runtime/scheduler.py", "runtime/graphs.py")}
    assert holds == {"runtime/trace.py": 1, "runtime/scheduler.py": 1,
                     "runtime/graphs.py": 2}


@pytest.mark.parametrize("rel,line", DECLARED, ids=[f"{r}:{n}" for r, n in DECLARED])
def test_each_guard_declaration_trips_on_a_planted_unguarded_write(rel, line):
    """A copy of the declaring class's source with one method added that
    writes the field without its lock: exactly that write is a DLG301."""
    src = (PORT / rel).read_text()
    tree = ast.parse(src)
    lines = src.splitlines()
    stmt = next(n for n in ast.walk(tree) if isinstance(n, (ast.Assign, ast.AnnAssign))
                and n.lineno <= line <= n.end_lineno)
    target = stmt.targets[0] if isinstance(stmt, ast.Assign) else stmt.target
    field = target.attr
    cls = next(n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
               and n.lineno <= line <= n.end_lineno)
    body = "\n".join(lines[cls.lineno - 1:cls.end_lineno])
    body += ("\n\n    def _planted(self):\n"
             f"        self.{field} = None\n")
    before = race_lint_source(rel, "\n".join(lines[cls.lineno - 1:cls.end_lineno]))
    after = race_lint_source(rel, body)
    new = [f for f in after if f.message not in {g.message for g in before}]
    assert [(f.rule, f.message) for f in new] == [(
        "DLG301", f"unguarded write to `self.{field}` (guarded-by "
                  f"`{GUARD_RE.search(lines[line - 1]).group('lock')}`) in "
                  f"`{cls.name}._planted`")]


def test_import_guards_cover_the_tools_lints_and_converters():
    """The last slice's modules are in the package that the blocked-jax
    import test and the per-file import scan walk (test_torch_guards.py)."""
    files = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"analysis/__main__.py", "analysis/findings.py", "analysis/race_lint.py",
            "analysis/serving_d2h.py", "converters/hf.py", "converters/meta_llama.py",
            "converters/grok1.py", "converters/tokenizer_llama3.py",
            "converters/tokenizer_spm.py", "tools/rehearse_70b.py",
            "tools/microbench.py", "tools/profile_decode.py",
            "tools/profile_prefill.py", "tools/exp_prefill_chunk.py",
            "tools/exp_decode_profile.py", "models/bench_specs.py"} <= files


# -- the baselined lock-free decisions, held under concurrent writers -------


def _hammer(write, read, n_reads=200):
    import threading

    stop = threading.Event()

    def writer():
        while not stop.is_set():
            write()
    t = threading.Thread(target=writer, daemon=True)
    t.start()
    try:
        return [read() for _ in range(n_reads)]
    finally:
        stop.set()
        t.join(timeout=5.0)
        assert not t.is_alive()


def test_kv_transfer_summary_consistent_under_concurrent_appends():
    """DLG305 baselined (stats.py KVTransferStats.summary): list(deque)
    snapshots the window in one call under the GIL; appends from another
    thread raise nothing and the aggregates stay sane."""
    from distributed_llama_tpu_torch.runtime.stats import KVTransferStats

    st = KVTransferStats(enabled=True, tier="mixed")
    outs = _hammer(lambda: st.note_transfer_ms(1.0), st.summary)
    assert all(isinstance(s, dict) for s in outs)


def test_tracer_recent_consistent_under_lock_free_appends():
    """DLG301/305 baselined (trace.py Tracer.event/recent): the ring's
    lock-free appends beside a reader's snapshot raise nothing and every
    snapshot holds whole events."""
    from distributed_llama_tpu_torch.runtime.trace import Tracer

    tr = Tracer()
    tr.configure(capacity=64)
    outs = _hammer(lambda: tr.event("enqueue", 1), lambda: tr.recent(32))
    assert outs[-1] and all(e["kind"] == "enqueue" for o in outs for e in o)
    assert all(len(o) <= 32 for o in outs)
