"""CLI: python -m distributed_llama_tpu_torch.analysis [--check] [--format=...]

Exit codes: without --check, always 0 unless the analyzer itself fails
(report mode — safe in `set -e` scripts); with --check, 1 when findings
beyond the baseline exist (the gate); 2 = analyzer failure.

Passes, in order: the dlrace lock-discipline lint (DLG3xx, over
runtime/, apps/, parallel/multihost.py and parallel/control.py), then the
serving-path D2H audit (DLG206). After the baseline split, hygiene
findings are appended: DLG108 for baseline entries that no longer match
anything in the tree, DLG109 for baseline entries carrying no one-line
justification. Hygiene findings are never themselves written to the
baseline — --update-baseline prunes/annotates instead. Nothing here
imports JAX, so there is no jaxpr level (the JAX package's --no-jaxpr).
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

from .findings import (Finding, format_github, format_json, format_text,
                       load_baseline, sort_findings, split_by_baseline,
                       unjustified_keys, write_baseline)
from .race_lint import PACKAGE, race_lint_package
from .serving_d2h import audit_serving_path

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")
# rules that describe the BASELINE's own hygiene — never allowlist keys
HYGIENE_RULES = ("DLG108", "DLG109")


def gather_findings(pkg_dir: str = PKG_DIR) -> list[Finding]:
    """Everything the gate judges, before the baseline split: dlrace, then
    the serving-path D2H audit. Shared by the CLI and the tests so they
    cannot drift. Raises on analyzer failure (a SyntaxError)."""
    findings = race_lint_package(pkg_dir, prefix=PACKAGE)
    findings.extend(audit_serving_path(pkg_dir, prefix=PACKAGE))
    return findings


def hygiene_findings(findings: list[Finding], baseline: dict) -> list[Finding]:
    """DLG108 stale allowlist keys + DLG109 unjustified entries."""
    out: list[Finding] = []
    leftover = (Counter(baseline.get("findings", []))
                - Counter(f.key() for f in findings))
    for key, n in sorted(leftover.items()):
        extra = f" (x{n})" if n > 1 else ""
        out.append(Finding(
            "DLG108", "warning", "<baseline>", 0,
            f"stale baseline: allowlist entry matches no current site"
            f"{extra}: `{key}` — prune with --update-baseline"))
    for key in unjustified_keys(baseline):
        out.append(Finding(
            "DLG109", "warning", "<baseline>", 0,
            f"baseline entry lacks a one-line justification: `{key}` — "
            "every allowlisted finding is a reviewed decision; write "
            "down why"))
    return out


def run(argv: list[str] | None = None, pkg_dir: str = PKG_DIR) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_llama_tpu_torch.analysis",
        description="dlgrind for the port: dlrace lock-discipline lint + "
                    "serving-path D2H audit")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on findings not in the baseline (the gate)")
    ap.add_argument("--format", choices=("text", "github", "json"),
                    default="text")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--update-baseline", action="store_true",
                    help="accept the current findings as the new baseline")
    ap.add_argument("--show-baselined", action="store_true",
                    help="also print findings the baseline accepts")
    args = ap.parse_args(argv)

    try:
        baseline = load_baseline(args.baseline)
        findings = gather_findings(pkg_dir)
    except SyntaxError as e:
        print(f"analyzer failed to parse source: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # analyzer crash, NOT a gate failure —
        # keep exit code 2 distinguishable from "new findings" (1)
        print(f"analysis failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    new, accepted = split_by_baseline(findings, baseline)

    if args.update_baseline:
        pinned = [f for f in findings if f.rule not in HYGIENE_RULES]
        write_baseline(args.baseline, pinned, {},
                       baseline.get("justifications", {}))
        print(f"baseline updated: {len(pinned)} finding(s) -> {args.baseline}")
        return 0

    # hygiene findings join AFTER the split/update paths: they describe
    # the baseline itself, so they can never be accepted by it
    new.extend(hygiene_findings(findings, baseline))

    to_show = sort_findings(new)
    if args.format == "github":
        out = format_github(to_show)
    elif args.format == "json":
        out = format_json(to_show)
    else:
        out = format_text(to_show, accepted=len(accepted))
        if args.show_baselined and accepted:
            out += "\n-- baselined --\n" + format_text(sort_findings(accepted))
    if out:
        print(out)
    if new and args.check:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(run())
