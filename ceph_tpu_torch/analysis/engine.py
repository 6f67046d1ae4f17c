"""graftlint rule engine: module loading, rule dispatch, reporting.

Counterpart of ``ceph_tpu/analysis/engine.py``. It lints the port:
``ceph_tpu_torch/``, ``chip_smoke.py`` and the port's tests
(``tests/test_torch_*.py`` and their helpers ``tests/_torch_*.py``).

Deviant-behavior checking (Engler et al., SOSP'01) as a harness: each
rule module contributes ``check(modules, ctx)`` returning findings; the
engine parses the file set once, runs every rule, applies inline
pragmas and the suppression baseline, and renders one report.  The last
report is cached process-wide so a live daemon can serve it over the
admin socket (``graftlint report``) without re-walking the repo on
every command.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

# directories never linted: the corpus holds deliberately-bad fixtures,
# __pycache__/caches hold no source of ours
EXCLUDE_GLOBS = (
    "*/lint_corpus/*", "*/__pycache__/*", "*/.git/*",
    "*/node_modules/*", "*/.ipynb_checkpoints/*",
)

# inline suppression: a finding whose source line (or the line above)
# carries ``graftlint: ignore[rule-name]`` is dropped at the source
PRAGMA = "graftlint: ignore["


@dataclass(frozen=True)
class Finding:
    rule: str       # rule family, e.g. "lock-order"
    path: str       # repo-relative posix path
    line: int
    symbol: str     # enclosing class.function, or "" at module scope
    message: str    # stable text: no line numbers, safe as baseline key

    @property
    def baseline_key(self) -> str:
        # line numbers drift with unrelated edits; identity is
        # rule + file + symbol + message
        return f"{self.rule}::{self.path}::{self.symbol}::{self.message}"

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym}: {self.message}"


@dataclass
class Module:
    """One parsed source file."""

    path: str        # absolute
    relpath: str     # repo-relative posix
    source: str
    tree: ast.AST
    lines: List[str] = field(default_factory=list)

    def pragma_suppressed(self, rule: str, line: int) -> bool:
        tag = f"{PRAGMA}{rule}]"
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines) and tag in self.lines[ln - 1]:
                return True
        return False


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)   # unsuppressed
    suppressed: List[Finding] = field(default_factory=list)  # baselined
    stale_baseline: List[str] = field(default_factory=list)
    files_checked: int = 0
    parse_errors: List[str] = field(default_factory=list)
    lock_graph: Optional[dict] = None   # set by the lockgraph rule
    # raw (held, acquired) -> (path, line) map for DOT export; not
    # JSON-serialized (tuple keys), hence outside lock_graph
    static_edges_raw: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return not self.findings and not self.parse_errors

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def summary(self) -> dict:
        return {
            "ok": self.ok,
            "files_checked": self.files_checked,
            "findings": len(self.findings),
            "suppressed": len(self.suppressed),
            "stale_baseline": len(self.stale_baseline),
            "by_rule": self.counts(),
            "parse_errors": self.parse_errors,
            "lock_graph": self.lock_graph,
        }

    def to_json(self) -> dict:
        return {
            **self.summary(),
            "finding_list": [vars(f) | {"key": f.baseline_key}
                             for f in self.findings],
            "suppressed_list": [f.baseline_key for f in self.suppressed],
        }

    def render_text(self) -> str:
        out = [f.render() for f in self.findings]
        out += [f"PARSE ERROR: {e}" for e in self.parse_errors]
        c = self.counts()
        tail = ", ".join(f"{k}={v}" for k, v in sorted(c.items())) or "clean"
        out.append(
            f"graftlint: {self.files_checked} files, "
            f"{len(self.findings)} finding(s) ({tail}), "
            f"{len(self.suppressed)} baselined")
        if self.stale_baseline:
            out.append(
                f"note: {len(self.stale_baseline)} stale baseline "
                f"entr{'y' if len(self.stale_baseline) == 1 else 'ies'} "
                f"(finding no longer fires; prune the baseline)")
        return "\n".join(out)


def repo_root() -> str:
    """The repo root: the directory holding the ceph_tpu_torch package."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(here)


# the port's tests and their helpers, at the top of tests/
TEST_GLOBS = ("test_torch_*.py", "_torch_*.py")


def default_paths(root: Optional[str] = None) -> List[str]:
    """The port's file set: the package, chip_smoke.py, and the port's
    tests with their helpers (never the deliberately-bad lint corpus,
    nor the kernel build cache)."""
    root = root or repo_root()
    out = []
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(root, "ceph_tpu_torch")):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "lint_corpus",
                                          "_build"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        out.append(smoke)
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        out.extend(os.path.join(tests, fn) for fn in sorted(os.listdir(tests))
                   if any(fnmatch.fnmatch(fn, g) for g in TEST_GLOBS))
    return out


def _excluded(path: str) -> bool:
    p = path.replace(os.sep, "/")
    return any(fnmatch.fnmatch(p, g) for g in EXCLUDE_GLOBS)


def load_modules(paths: Sequence[str],
                 root: Optional[str] = None,
                 respect_excludes: bool = False) -> tuple:
    """Parse the file set; returns (modules, parse_errors).  Exclusion
    globs apply only on request — an explicitly listed file is always
    linted (that is how the corpus self-tests lint tests/lint_corpus)."""
    root = root or repo_root()
    modules, errors = [], []
    for path in paths:
        if respect_excludes and _excluded(path):
            continue
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{os.path.relpath(path, root)}: {e}")
            continue
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        modules.append(Module(path=path, relpath=rel, source=source,
                              tree=tree, lines=source.splitlines()))
    return modules, errors


class LintContext:
    """Cross-rule state: runtime lock edges to merge, collected lock
    graph (for DOT export), engine options."""

    def __init__(self, runtime_edges: Optional[Dict[str, list]] = None):
        # name -> iterable of successor names (the runtime lockdep dump)
        self.runtime_edges = runtime_edges or {}
        self.lock_graph: Optional[dict] = None  # filled by lockgraph rule
        self.static_edges_raw: Optional[dict] = None  # ditto, for DOT


def all_rules():
    """The registered rule families, import-cycle-free."""
    from ceph_tpu_torch.analysis import async_errors, asyncio_rules, \
        awaitrace, device_dispatch, lockgraph, planar_hygiene, \
        rpc_timeout, symmetry, taskspawn, testsleep, torch_hygiene

    return [lockgraph, torch_hygiene, symmetry, asyncio_rules, taskspawn,
            rpc_timeout, device_dispatch, async_errors, planar_hygiene,
            awaitrace, testsleep]


# cached last report (admin socket `graftlint report` serves this)
_LAST_REPORT: Optional[Report] = None


def last_report(run_if_missing: bool = True) -> Optional[dict]:
    """The most recent lint summary, running a fresh whole-repo lint
    (with the shipped baseline) when none is cached."""
    global _LAST_REPORT
    if _LAST_REPORT is None and run_if_missing:
        from ceph_tpu_torch.analysis.baseline import default_baseline_path, \
            load_baseline

        _LAST_REPORT = run_lint(baseline=load_baseline(
            default_baseline_path()))
    return _LAST_REPORT.summary() if _LAST_REPORT is not None else None


def run_lint(paths: Optional[Sequence[str]] = None,
             rules=None,
             baseline: Optional[set] = None,
             runtime_edges: Optional[Dict[str, list]] = None,
             root: Optional[str] = None) -> Report:
    """Parse ``paths`` (default: the whole repo), run every rule family,
    apply pragma + baseline suppression, cache and return the Report."""
    global _LAST_REPORT
    root = root or repo_root()
    explicit = paths is not None
    if paths is None:
        paths = default_paths(root)
    modules, errors = load_modules(paths, root,
                                   respect_excludes=not explicit)
    ctx = LintContext(runtime_edges=runtime_edges)
    findings: List[Finding] = []
    for rule_mod in (rules if rules is not None else all_rules()):
        findings.extend(rule_mod.check(modules, ctx))
    by_rel = {m.relpath: m for m in modules}
    findings = [f for f in findings
                if not (f.path in by_rel and
                        by_rel[f.path].pragma_suppressed(f.rule, f.line))]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    baseline = baseline or set()
    kept = [f for f in findings if f.baseline_key not in baseline]
    suppressed = [f for f in findings if f.baseline_key in baseline]
    live_keys = {f.baseline_key for f in findings}
    stale = sorted(k for k in baseline if k not in live_keys)

    report = Report(findings=kept, suppressed=suppressed,
                    stale_baseline=stale, files_checked=len(modules),
                    parse_errors=errors, lock_graph=ctx.lock_graph)
    report.static_edges_raw = ctx.static_edges_raw
    # cache WHOLE-REPO runs only: `graftlint report` must never serve a
    # subset lint (e.g. a single-file run from a test or tool, or one
    # rule family over every file) as if it were the repo's state
    if not explicit and rules is None:
        _LAST_REPORT = report
    return report


def dump_report_json(report: Report) -> str:
    return json.dumps(report.to_json(), indent=2, sort_keys=True)
