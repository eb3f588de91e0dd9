"""The port's static lint gate: ``python -m parmmg_tpu_torch.lint``.

Runs the port's AST rules (R2-R4, R6-R10) over ``parmmg_tpu_torch/``,
``tests/test_torch_*.py``, ``tests/torch_parity.py`` and ``chip_smoke.py``
in seconds — no torch, jax or parmmg_tpu import — and fails on any
violation that is neither suppressed in source (``# lint: ok(<rule>) —
reason``) nor in ``parmmg_tpu_torch/lint/baseline.json``.  R4 (knob
registry) ignores the baseline: it must hold exactly.

Usage:
    python -m parmmg_tpu_torch.lint                 # the gate
    python -m parmmg_tpu_torch.lint -v              # + the suppressions
    python -m parmmg_tpu_torch.lint --rules R3,R4   # subset
    python -m parmmg_tpu_torch.lint --sarif out.sarif
        also write a SARIF 2.1.0 log: one result per violation (new =
        error, baselined = warning, suppressed results carry their
        in-source justification)
    python -m parmmg_tpu_torch.lint --changed-only
        analyze the WHOLE tree (the interprocedural summaries need it)
        but report and gate only findings in git-dirty files
    python -m parmmg_tpu_torch.lint --baseline-update
        rewrite the baseline to the current violation set (an
        intentional rotation: only in a change that argues why)

Exit codes: 0 green, 1 a violation beyond the baseline (or a suppression
problem), 2 a usage error or an import of torch, jax or parmmg_tpu.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from . import (BASELINE_REL, RULE_TITLES, GateResult, LintReport,
               baseline_payload, format_report, gate, load_baseline,
               run_lint)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASELINE = os.path.join(ROOT, BASELINE_REL)
#: modules the linter must never have imported
_FORBIDDEN = ("torch", "jax", "parmmg_tpu")


# lint: ok(R3) — a usage note of this command line, on its stderr
def _changed_files() -> set:
    """Repo-relative paths of git-dirty files (staged, unstaged and
    untracked) — the --changed-only report filter."""
    try:
        out = subprocess.run(
            ["git", "status", "--porcelain"], cwd=ROOT,
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except Exception as e:
        print(f"lint: --changed-only needs git ({e})", file=sys.stderr)
        return set()
    rels = set()
    for ln in out.splitlines():
        if len(ln) < 4:
            continue
        path = ln[3:]
        # renames show as "old -> new": the NEW path holds the code
        if " -> " in path:
            path = path.split(" -> ", 1)[1]
        rels.add(path.strip().strip('"'))
    return rels


def _sarif_payload(report, result, titles) -> dict:
    """SARIF 2.1.0: one result per violation.  New violations are
    errors, baselined ones warnings (with the gate state in
    properties), suppressed ones carry their in-source reason as a
    SARIF suppression; SUPP problems (reasonless/unknown-rule
    comments, parse errors) are errors under the pseudo-rule SUPP."""
    new_ids = {id(v) for v in result.new}

    def loc(v):
        region = {"startLine": max(int(v.line), 1)}
        return [{"physicalLocation": {
            "artifactLocation": {"uri": v.path,
                                 "uriBaseId": "SRCROOT"},
            "region": region}}]

    def res(v, level, state, suppression=None):
        r = {"ruleId": v.rule,
             "level": level,
             "message": {"text": v.message},
             "locations": loc(v),
             "properties": {"state": state,
                            "scope": v.scope,
                            "detail": v.detail,
                            "key": v.key}}
        if suppression is not None:
            r["suppressions"] = [{
                "kind": "inSource",
                "justification": suppression.reason,
                "properties": {
                    "commentLine": suppression.comment_line}}]
        return r

    results = []
    for v in result.bad:
        results.append(res(v, "error", "suppression-problem"))
    for v in report.violations:
        if id(v) in new_ids:
            results.append(res(v, "error", "new"))
        else:
            results.append(res(v, "warning", "baselined"))
    for v, s in report.suppressed:
        results.append(res(v, "note", "suppressed", suppression=s))

    rules = [{"id": rid,
              "shortDescription": {"text": titles.get(rid, rid)}}
             for rid in sorted(titles)]
    rules.append({"id": "SUPP", "shortDescription": {
        "text": "suppression hygiene (reason mandatory, rule ids must "
                "exist, files must parse)"}})
    return {
        "$schema": "https://docs.oasis-open.org/sarif/sarif/v2.1.0/"
                   "errata01/os/schemas/sarif-schema-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "parmmg-torch-lint",
                "informationUri":
                    "parmmg_tpu_torch/lint/__init__.py",
                "rules": rules}},
            "originalUriBaseIds": {"SRCROOT": {"uri": "file:///"}},
            "results": results,
        }],
    }


# lint: ok(R3) — the gate's report is this command's own stdout
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m parmmg_tpu_torch.lint",
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rules", default="",
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--baseline-update", action="store_true",
                    help="rewrite the baseline from the current "
                         "violations (R4 stays unbaselined)")
    ap.add_argument("--sarif", metavar="PATH", default="",
                    help="write a SARIF 2.1.0 log of every violation "
                         "(new/baselined/suppressed) to PATH")
    ap.add_argument("--changed-only", action="store_true",
                    help="report and gate only findings in git-dirty "
                         "files (analysis still covers the whole tree)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    rules = tuple(r.strip() for r in args.rules.split(",")
                  if r.strip()) or None
    try:
        report = run_lint(ROOT, rules=rules)
    except ValueError as e:
        # a typo'd --rules must not read like a lint failure
        print(f"lint: {e}", file=sys.stderr)
        return 2

    if args.baseline_update:
        import json
        payload = baseline_payload(report)
        # R4 is never grandfathered — drop its keys so the registry
        # contract stays exact
        payload["grandfathered"] = {
            k: v for k, v in payload["grandfathered"].items()
            if not k.startswith("R4:")}
        with open(BASELINE, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"lint: baseline rewritten with "
              f"{len(payload['grandfathered'])} grandfathered keys "
              f"-> {BASELINE}")
        return 0

    baseline = load_baseline(BASELINE)
    result = gate(report, baseline)

    if args.changed_only:
        changed = _changed_files()
        # the SUMMARIES were computed over the full tree (an edit in
        # a callee changes facts at untouched call sites — those still
        # surface in the next full run / CI); the REPORT narrows to
        # what the working copy actually touches
        report = LintReport(
            [v for v in report.violations if v.path in changed],
            [(v, s) for v, s in report.suppressed
             if v.path in changed],
            [v for v in report.bad if v.path in changed])
        result = GateResult(
            [v for v in result.new if v.path in changed],
            [v for v in result.bad if v.path in changed],
            result.burndown)
        print(f"lint: --changed-only over {len(changed)} dirty "
              "file(s)")

    print(format_report(report, result))

    if args.sarif:
        import json
        doc = _sarif_payload(report, result, RULE_TITLES)
        with open(args.sarif, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        n = len(doc["runs"][0]["results"])
        print(f"lint: SARIF log with {n} result(s) -> {args.sarif}")

    if args.verbose:
        print("\n-- suppressed (reasoned, in-source) --")
        for v, s in report.suppressed:
            print(f"{v.rule} {v.path}:{v.line} [{v.scope}] {v.detail}"
                  f"  # {s.reason}")

    dt = time.perf_counter() - t0
    print(f"\nlint: {len(result.new)} new, "
          f"{sum(b['current'] for b in result.burndown.values())} "
          f"baselined ("
          f"{sum(b['retired'] for b in result.burndown.values())} "
          f"retired), {len(report.suppressed)} suppressed, "
          f"{len(result.bad)} suppression problems  [{dt:.2f}s]")

    # the linter's own contract: static means static — neither torch, jax
    # nor the JAX package may have been imported by running it
    loaded = [m for m in _FORBIDDEN if m in sys.modules]
    if loaded:
        print(f"lint: INTERNAL ERROR — the linter imported {loaded}",
              file=sys.stderr)
        return 2
    if not result.ok:
        print("lint: FAIL (fix, suppress with a reason, or argue a "
              "baseline rotation)", file=sys.stderr)
        return 1
    print("lint: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
