"""The port's lint engine: file model, suppressions, baseline gate.

The port's copy of the JAX package's ``lint/engine.py``, with the same
contract, over the port's own tree.  Pure stdlib (``ast`` + ``json``): it
imports neither ``torch``, ``jax`` nor ``parmmg_tpu``, and reads the
sources it checks as text.

- :class:`SourceFile` — parsed module + the per-line suppression map
  (``# lint: ok(R3) — reason``; the reason is mandatory, a reasonless
  suppression is itself a violation, rule ``SUPP``);
- :class:`LintContext` — the file set plus the cross-file registries
  some rules need (the port's ``api/knobs.py`` knob dict, its
  ``resilience.faults.SITES`` / ``recover.LADDER`` name sets, the
  README text), all recovered by AST/text so nothing heavy imports;
- :func:`run_lint` — run a rule subset over a root (or an explicit
  file dict, the unit-test entry) and split raw findings into
  suppressed / unsuppressed;
- :func:`gate` + :func:`load_baseline` / :func:`baseline_payload` —
  the zero-new-violations gate: ``parmmg_tpu_torch/lint/baseline.json``
  holds the port's violations of the day the linter came, as
  ``{key: count}``, and the gate fails only on keys (or counts) beyond
  it, printing a per-rule burn-down.  R4 never takes the baseline.

Violation identity (:attr:`Violation.key`) is ``rule:path:scope:detail``
— no line numbers, so unrelated edits that shift lines never invalidate
the baseline, while a NEW offender in a touched function still fails.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from collections import Counter

#: every rule the engine knows; rule modules register their checker in
#: RULES via :func:`rule` at import time (lint/__init__ imports them).
RULES: dict[str, "object"] = {}

RULE_TITLES = {
    "R2": "host-sync (no stray device->host reads on the hot paths)",
    "R3": "obs-routing (no bare print outside obs/; use obs.trace.log)",
    "R4": "knob-registry (PMTORCH_* reads match api/knobs.py + README)",
    "R6": "name-schemes (static dotted metric/trace/fault names)",
    "R7": "mh-allgather (no pull_host/all_gather_json host gather on "
          "the pod hot path; route band tables through pod.gather_band)",
    "R8": "spmd-alignment (no collective control-dependent on "
          "rank-divergent state; mh_uniform/allgather-agreed only)",
    "R9": "lock-discipline (acyclic lock order; no collective/"
          "subprocess dispatch under a held lock; guarded "
          "cross-thread fields)",
    "R10": "shape-ladder (device-tensor shapes from measured ints "
           "must pass bucket()/pad_comm_tables)",
    "SUPP": "suppression hygiene (reason required)",
}


def rule(rid: str):
    """Decorator registering ``check(ctx) -> list[Violation]`` under a
    rule id."""
    def deco(fn):
        RULES[rid] = fn
        return fn
    return deco


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str            # repo-relative, posix separators
    line: int
    scope: str           # enclosing qualname, or "<module>"
    detail: str          # stable offender tag (callee / knob / name)
    message: str
    #: extra lines a suppression may sit on (e.g. the enclosing def
    #: line for R2's whole-function fallback exemption); not part of
    #: the identity key
    anchor_lines: tuple = ()

    @property
    def key(self) -> str:
        """Line-free identity used by suppression-independent baseline
        matching."""
        return f"{self.rule}:{self.path}:{self.scope}:{self.detail}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int            # line the suppression APPLIES to
    rules: tuple
    reason: str
    comment_line: int    # line the comment physically sits on


_SUPP_RE = re.compile(
    r"#\s*lint:\s*ok\(\s*([A-Za-z0-9_,\s]+?)\s*\)\s*(.*)$")
# separators allowed between ok(...) and the reason: em/en dash, hyphen,
# colon — whatever is left after stripping them must be non-empty
_SEP_RE = re.compile(r"^[\s—–:\-]+")


class SourceFile:
    """One parsed module: text, ast, parent links, suppression map."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.parse_error: str | None = None
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:           # pragma: no cover - tree is clean
            self.tree = None
            self.parse_error = f"{rel}:{e.lineno}: {e.msg}"
        self.suppressions: dict[int, list[Suppression]] = {}
        self.bad_suppressions: list[Violation] = []
        self._def_index: list | None = None
        self._scan_suppressions()

    def _scan_suppressions(self) -> None:
        for i, ln in enumerate(self.lines, start=1):
            m = _SUPP_RE.search(ln)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            reason = _SEP_RE.sub("", m.group(2)).strip()
            # standalone comment -> applies to the next non-comment
            # line (the reason may wrap onto continuation comment
            # lines); trailing comment -> applies to its own line
            standalone = ln.strip().startswith("#")
            target = i
            if standalone:
                target = i + 1
                while (target <= len(self.lines)
                       and self.lines[target - 1].strip()
                       .startswith("#")):
                    target += 1
            if not reason:
                self.bad_suppressions.append(Violation(
                    "SUPP", self.rel, i, "<comment>",
                    ",".join(rules) or "?",
                    "suppression without a reason — write "
                    "'# lint: ok(<rule>) — why this is allowed'"))
                continue
            unknown = [r for r in rules if r not in RULE_TITLES]
            if unknown or not rules:
                self.bad_suppressions.append(Violation(
                    "SUPP", self.rel, i, "<comment>",
                    ",".join(rules) or "?",
                    f"suppression names unknown rule(s) {unknown}"))
                continue
            s = Suppression(target, rules, reason, i)
            self.suppressions.setdefault(target, []).append(s)

    def suppressed(self, rid: str, line: int,
                   extra_lines: tuple = ()) -> Suppression | None:
        """Suppression covering ``line`` (or any of ``extra_lines`` —
        rules pass e.g. the enclosing ``def`` line for function-scoped
        exemptions) for rule ``rid``."""
        for ln in (line, *extra_lines):
            for s in self.suppressions.get(ln, ()):
                if rid in s.rules:
                    return s
        return None

    def def_anchors(self, line: int) -> tuple:
        """Def + decorator lines of the innermost function enclosing
        ``line`` — the engine-level anchors that make a def-line
        ``# lint: ok(...)`` exempt the whole function identically for
        EVERY rule (not just the ones that pass anchor_lines)."""
        if self.tree is None:
            return ()
        if self._def_index is None:
            idx = []
            for node in ast.walk(self.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    anchors = (node.lineno,) + tuple(
                        d.lineno for d in node.decorator_list)
                    start = min(anchors)
                    end = getattr(node, "end_lineno", None) \
                        or node.lineno
                    idx.append((start, end, anchors))
            self._def_index = idx
        best = None
        for start, end, anchors in self._def_index:
            if start <= line <= end and (
                    best is None or end - start < best[0]):
                best = (end - start, anchors)
        return best[1] if best else ()


# ---------------------------------------------------------------------------
# shared AST helpers (used by the rule modules)
# ---------------------------------------------------------------------------
def dotted(node) -> str:
    """Dotted source name of a Name/Attribute chain (``torch.zeros``,
    ``os.environ.get``); "" for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def walk_scoped(tree):
    """Yield ``(node, qualname, func_stack)`` for every node, where
    ``func_stack`` is the chain of enclosing FunctionDef nodes and
    ``qualname`` joins class/function names (module scope =
    "<module>").  Decorator expressions are attributed to the scope
    CONTAINING the decorated def (a decorator on a module-level def is a
    module-scope construction, not one "inside" that function)."""
    def visit(node, names, funcs):
        qn = ".".join(names) if names else "<module>"
        deco = set()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            deco = {id(d) for d in node.decorator_list}
        for child in ast.iter_child_nodes(node):
            if id(child) in deco:
                continue           # already attributed to the outer scope
            is_fn = isinstance(child, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
            is_cls = isinstance(child, ast.ClassDef)
            if is_fn or is_cls:
                for d in child.decorator_list:
                    for n in ast.walk(d):
                        yield n, qn, tuple(funcs)
            yield child, qn, tuple(funcs)
            if is_fn or is_cls:
                yield from visit(child, names + [child.name],
                                 funcs + [child] if is_fn else funcs)
            else:
                yield from visit(child, names, funcs)
    yield from visit(tree, [], [])


def str_const(node) -> str | None:
    return node.value if (isinstance(node, ast.Constant)
                          and isinstance(node.value, str)) else None


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------
PKG = "parmmg_tpu_torch/"
KNOBS_REL = "parmmg_tpu_torch/api/knobs.py"
FAULTS_REL = "parmmg_tpu_torch/resilience/faults.py"
RECOVER_REL = "parmmg_tpu_torch/resilience/recover.py"
BASELINE_REL = "parmmg_tpu_torch/lint/baseline.json"


class LintContext:
    def __init__(self, files: dict[str, SourceFile],
                 readme_text: str = ""):
        self.files = files
        self.readme_text = readme_text

    def iter(self, prefixes: tuple, exclude: tuple = ()):
        """SourceFiles under any of ``prefixes`` (a rel file name is
        its own prefix), minus ``exclude`` prefixes."""
        for rel in sorted(self.files):
            if not rel.endswith(".py"):
                continue
            if not any(rel == p or rel.startswith(p) for p in prefixes):
                continue
            if any(rel == p or rel.startswith(p) for p in exclude):
                continue
            yield self.files[rel]

    # -- registries recovered by AST (never imported) -----------------------
    def knob_registry(self) -> dict[str, dict]:
        """{knob: {type, default, doc}} parsed from api/knobs.py's
        KNOBS dict literal."""
        sf = self.files.get(KNOBS_REL)
        out: dict[str, dict] = {}
        if sf is None or sf.tree is None:
            return out
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            else:
                continue
            if not (any(isinstance(t, ast.Name) and t.id == "KNOBS"
                        for t in targets)
                    and isinstance(node.value, ast.Dict)):
                continue
            for k, v in zip(node.value.keys, node.value.values):
                name = str_const(k)
                if name is None:
                    continue
                args = [str_const(a) for a in getattr(v, "args", [])]
                out[name] = {
                    "line": k.lineno,
                    "type": args[0] if len(args) > 0 else "",
                    "default": args[1] if len(args) > 1 else "",
                    "doc": args[2] if len(args) > 2 else "",
                }
        return out

    def _const_names(self, rel: str, var: str) -> set:
        """String keys/items of a module-level dict/tuple constant
        (faults.SITES, recover.LADDER)."""
        sf = self.files.get(rel)
        if sf is None or sf.tree is None:
            return set()
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == var
                            for t in node.targets)):
                continue
            v = node.value
            if isinstance(v, ast.Dict):
                return {s for s in (str_const(k) for k in v.keys) if s}
            if isinstance(v, (ast.Tuple, ast.List, ast.Set)):
                return {s for s in (str_const(e) for e in v.elts) if s}
        return set()

    def fault_sites(self) -> set:
        return self._const_names(FAULTS_REL, "SITES")

    def ladder_steps(self) -> set:
        return self._const_names(RECOVER_REL, "LADDER")


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------
#: the port's tree: its package, its tests and its chip smoke script
SCAN_ROOTS = ("parmmg_tpu_torch",)
SCAN_TESTS = ("tests", "test_torch_", "torch_parity.py")
SCAN_SINGLES = ("chip_smoke.py",)


def collect_files(root: str) -> dict[str, SourceFile]:
    files: dict[str, SourceFile] = {}

    def add(p):
        rel = os.path.relpath(p, root).replace(os.sep, "/")
        with open(p, encoding="utf-8") as f:
            files[rel] = SourceFile(rel, f.read())

    for top in SCAN_ROOTS:
        base = os.path.join(root, top)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and
                           not d.startswith(".")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    add(os.path.join(dirpath, fn))
    tdir, tprefix, tsingle = SCAN_TESTS
    tbase = os.path.join(root, tdir)
    if os.path.isdir(tbase):
        for fn in sorted(os.listdir(tbase)):
            if fn == tsingle or (fn.startswith(tprefix)
                                 and fn.endswith(".py")):
                add(os.path.join(tbase, fn))
    for single in SCAN_SINGLES:
        p = os.path.join(root, single)
        if os.path.exists(p):
            add(p)
    return files


@dataclasses.dataclass
class LintReport:
    violations: list       # unsuppressed, gate-relevant
    suppressed: list       # (Violation, Suppression) pairs
    bad: list              # SUPP violations + parse errors

    def by_rule(self) -> dict[str, list]:
        out: dict[str, list] = {}
        for v in self.violations:
            out.setdefault(v.rule, []).append(v)
        return out


def run_lint(root: str | None = None, rules=None,
             files: dict[str, SourceFile] | None = None,
             readme_text: str | None = None) -> LintReport:
    """Run ``rules`` (default: all registered) over ``root`` (or an
    explicit ``files`` dict — the test entry point)."""
    if files is None:
        assert root is not None
        files = collect_files(root)
    if readme_text is None:
        readme_text = ""
        if root is not None:
            rp = os.path.join(root, "README.md")
            if os.path.exists(rp):
                with open(rp, encoding="utf-8") as f:
                    readme_text = f.read()
    ctx = LintContext(files, readme_text)
    wanted = tuple(rules) if rules else tuple(sorted(RULES))
    unknown = [r for r in wanted if r not in RULES]
    if unknown:
        raise ValueError(f"unknown lint rule id(s) {unknown}; "
                         f"known: {sorted(RULES)}")
    raw: list[Violation] = []
    for rid in wanted:
        raw.extend(RULES[rid](ctx))
    bad: list[Violation] = []
    for sf in files.values():
        bad.extend(sf.bad_suppressions)
        if sf.parse_error:
            bad.append(Violation("SUPP", sf.rel, 0, "<module>",
                                 "parse-error", sf.parse_error))
    kept, supp = [], []
    for v in raw:
        sf = files.get(v.path)
        # rule-provided anchors plus the engine-resolved enclosing-def
        # lines: a def-line suppression exempts the whole function for
        # any rule, decorated or not
        s = sf.suppressed(
            v.rule, v.line,
            tuple(v.anchor_lines) + sf.def_anchors(v.line)) if sf \
            else None
        (supp if s else kept).append((v, s) if s else v)
    kept.sort(key=lambda v: (v.path, v.line, v.rule))
    return LintReport(kept, supp, bad)


# ---------------------------------------------------------------------------
# baseline gate
# ---------------------------------------------------------------------------
def load_baseline(path: str) -> dict:
    """{key: count} from a baseline file (empty when absent)."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    g = doc.get("grandfathered", doc)
    return {str(k): int(v) for k, v in g.items()}


def baseline_payload(report: LintReport) -> dict:
    counts = Counter(v.key for v in report.violations)
    return {"version": 1,
            "note": "the port's violations of the day the linter "
                    "came; burn down, never add — python -m "
                    "parmmg_tpu_torch.lint --baseline-update rewrites "
                    "after an intentional rotation",
            "grandfathered": {k: counts[k] for k in sorted(counts)}}


@dataclasses.dataclass
class GateResult:
    new: list              # violations beyond the baseline
    bad: list              # SUPP findings (never baselineable)
    burndown: dict         # rule -> {baseline, current, retired}

    @property
    def ok(self) -> bool:
        return not self.new and not self.bad


def gate(report: LintReport, baseline: dict,
         no_baseline_rules: tuple = ("R4",)) -> GateResult:
    """Zero-new-violations gate.  Rules in ``no_baseline_rules`` ignore
    the baseline entirely (the knob registry ships clean from day one)."""
    counts = Counter(v.key for v in report.violations)
    allowed = dict(baseline)
    for k in list(allowed):
        rid = k.split(":", 1)[0]
        if rid in no_baseline_rules:
            del allowed[k]
    new: list[Violation] = []
    seen: Counter = Counter()
    for v in report.violations:
        seen[v.key] += 1
        if seen[v.key] > allowed.get(v.key, 0):
            new.append(v)
    burn: dict[str, dict] = {}
    for k, n in allowed.items():
        rid = k.split(":", 1)[0]
        b = burn.setdefault(rid, {"baseline": 0, "current": 0,
                                  "retired": 0})
        b["baseline"] += n
        cur = min(counts.get(k, 0), n)
        b["current"] += cur
        b["retired"] += n - cur
    return GateResult(new, list(report.bad), burn)


def format_report(report: LintReport, result: GateResult) -> str:
    lines = []
    for v in result.bad:
        lines.append(f"SUPP {v.path}:{v.line}: {v.message}")
    for v in result.new:
        lines.append(f"{v.rule} {v.path}:{v.line} [{v.scope}] "
                     f"{v.message}")
    lines.append("")
    lines.append(f"{'rule':5s} {'new':>4s} {'baselined':>9s} "
                 f"{'retired':>8s} {'suppressed':>10s}  title")
    nsupp = Counter(v.rule for v, _ in report.suppressed)
    nnew = Counter(v.rule for v in result.new)
    for rid in sorted(RULE_TITLES):
        if rid == "SUPP":
            continue
        b = result.burndown.get(rid, {})
        lines.append(f"{rid:5s} {nnew.get(rid, 0):4d} "
                     f"{b.get('current', 0):9d} "
                     f"{b.get('retired', 0):8d} "
                     f"{nsupp.get(rid, 0):10d}  {RULE_TITLES[rid]}")
    return "\n".join(lines)
