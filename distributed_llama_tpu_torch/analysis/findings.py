"""Finding model, suppression comments, baseline, and output formats: a copy
of the JAX package's analysis/findings.py for the port's own gate.

A `Finding` is one diagnostic: a rule id (DLG2xx = the serving-path D2H
audit, DLG3xx = the dlrace lock-discipline lint, DLG108/109 = the
baseline's own hygiene), a severity, a file:line anchor, and a message.
The baseline file (analysis/baseline.json) allowlists ACCEPTED findings —
deliberate host-device boundary syncs and lock-free hot paths, each with a
one-line justification — so the gate fails only on regressions, never on
the accepted steady state.

Baseline keys deliberately omit the line number: an unrelated edit that
shifts a deliberate sync down three lines must not break the gate. The key
is (rule, file, message); messages are written to be stable per-site (they
name the offending call/variable, not positions). Identical keys are
COUNTED, not deduplicated: two accepted `.item()` syncs in engine.py are
two baseline entries, and a third occurrence of the same message is a new
finding — without counts, one allowlisted sync would mask any number of
reintroduced copies.
"""

from __future__ import annotations

import dataclasses
import json
import re

SEVERITIES = ("error", "warning", "info")

# inline suppression: `# dlgrind: ignore[DLG101]`, `ignore[DLG101,DLG203]`,
# or a bare `# dlgrind: ignore` (suppresses every rule on that line).
# The dlrace (DLG3xx) family reuses the same syntax under its own marker:
# `# dlrace: ignore[DLG305]` — one mechanism, two spellings, so a lock-
# discipline suppression reads as what it is.
_IGNORE_RE = re.compile(
    r"#\s*dl(?:grind|race):\s*ignore(?:\[(?P<rules>[A-Z0-9,\s]+)\])?")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                # "DLG101"
    severity: str            # error | warning | info
    file: str                # repo-relative posix path, or "<entry:NAME>"
    line: int                # 1-based; 0 for whole-entry-point findings
    message: str

    def key(self) -> str:
        """Stable baseline key (no line number — see module docstring)."""
        return f"{self.rule}|{self.file}|{self.message}"

    def anchor(self) -> str:
        return f"{self.file}:{self.line}" if self.line else self.file


def parse_suppressions(source: str) -> dict[int, set[str] | None]:
    """Map 1-based line number -> suppressed rule ids (None = all rules).

    Every finding of the port's passes anchors to a source line the
    comment can sit on; the hygiene findings (`<baseline>`, line 0) cannot
    be suppressed and are fixed in the baseline instead.
    """
    out: dict[int, set[str] | None] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(text)
        if not m:
            continue
        rules = m.group("rules")
        if rules is None:
            out[i] = None
        else:
            ids = {r.strip() for r in rules.split(",") if r.strip()}
            out[i] = ids or None
    return out


def is_suppressed(f: Finding, supp: dict[int, set[str] | None]) -> bool:
    rules = supp.get(f.line, "missing")
    if rules == "missing":
        return False
    return rules is None or f.rule in rules


# -- baseline ---------------------------------------------------------------


def load_baseline(path: str) -> dict:
    """{"findings": [key, ...], "fingerprints": {entry: hex},
    "justifications": {key: one-line reason}} (all optional in the file;
    absent file = empty baseline, i.e. everything is new). Duplicate keys
    in "findings" are meaningful — one entry per accepted site (see
    module docstring). Every distinct findings key must carry a
    justification: an allowlist entry is a reviewed decision, and the
    baseline is where the decision's one-line rationale lives."""
    try:
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {"findings": [], "fingerprints": {}, "justifications": {}}
    return {"findings": list(raw.get("findings", [])),
            "fingerprints": dict(raw.get("fingerprints", {})),
            "justifications": dict(raw.get("justifications", {}))}


def write_baseline(path: str, findings: list[Finding],
                   fingerprints: dict[str, str],
                   justifications: dict[str, str] | None = None) -> None:
    keys = sorted(f.key() for f in findings)  # one entry PER SITE
    just = justifications or {}
    data = {
        "findings": keys,
        "fingerprints": dict(sorted(fingerprints.items())),
        # carry forward only justifications for keys that still exist;
        # keys without one get an explicit TODO so the gap is visible in
        # review instead of silently absent
        "justifications": {k: just.get(k, "TODO: justify this entry")
                           for k in sorted(set(keys))},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


def unjustified_keys(baseline: dict) -> list[str]:
    """Distinct baseline findings keys with no (or placeholder) one-line
    justification — the gate treats these as findings (DLG109)."""
    just = baseline.get("justifications", {})
    out = []
    for key in sorted(set(baseline.get("findings", []))):
        reason = str(just.get(key, "")).strip()
        if not reason or reason.startswith("TODO"):
            out.append(key)
    return out


def split_by_baseline(
    findings: list[Finding], baseline: dict,
) -> tuple[list[Finding], list[Finding]]:
    """(new, accepted). Multiset semantics: a key appearing N times in the
    baseline accepts at most N findings with that key — occurrence N+1 is
    new (a reintroduced copy of an allowlisted sync must not ride along)."""
    from collections import Counter

    budget = Counter(baseline.get("findings", []))
    new, accepted = [], []
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            accepted.append(f)
        else:
            new.append(f)
    return new, accepted


# -- output formats ---------------------------------------------------------

_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}


def sort_findings(findings: list[Finding]) -> list[Finding]:
    return sorted(findings, key=lambda f: (_SEV_ORDER.get(f.severity, 9),
                                           f.file, f.line, f.rule))


def format_text(findings: list[Finding], *, accepted: int = 0) -> str:
    lines = [f"{f.anchor()}: {f.severity} {f.rule}: {f.message}"
             for f in sort_findings(findings)]
    lines.append(f"{len(findings)} finding(s)"
                 + (f", {accepted} baselined" if accepted else ""))
    return "\n".join(lines)


def format_github(findings: list[Finding]) -> str:
    """GitHub Actions annotation syntax — findings render inline on PRs."""
    out = []
    for f in sort_findings(findings):
        level = "error" if f.severity == "error" else "warning"
        # '<baseline>' pseudo-files carry no annotatable path; anchor the
        # annotation to the baseline file so it still surfaces on the PR
        file = f.file if not f.file.startswith("<") else (
            "distributed_llama_tpu_torch/analysis/baseline.json")
        line = max(f.line, 1)
        msg = f"{f.rule}: {f.message}".replace("%", "%25").replace(
            "\n", "%0A")
        out.append(f"::{level} file={file},line={line}::{msg}")
    return "\n".join(out)


def format_json(findings: list[Finding]) -> str:
    return json.dumps([dataclasses.asdict(f) for f in sort_findings(findings)],
                      indent=2)
