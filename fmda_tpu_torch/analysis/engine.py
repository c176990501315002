"""Pluggable framework-aware static analysis over the ``fmda_tpu_torch``
tree.

The port keeps the reference package's hardest contracts: never-abort
chaos guards, counted loss, a router that imports no framework, monotonic
span clocks, logging hygiene, lock discipline over a threaded serving
stack (MicroBatcher, gateways, router pumps, buses, tracer rings, metrics
registries), replay on a virtual clock, JSON kept off the hot path and a
symmetric wire protocol.  This module is the engine the checks of those
contracts plug into:

- :class:`ParsedModule` — one ``ast.parse`` + comment map per file,
  shared by every rule (the whole suite is one parse pass over the
  package; ``chip_smoke.py``'s lint phase holds it to seconds);
- :class:`Rule` — per-module ``check()`` visitors plus a cross-module
  ``finish()`` hook for whole-program rules (topic cross-checks, the
  drift inventory);
- :class:`Finding` — ``path:line`` + rule id + severity + a stable,
  line-free message that doubles as the baseline key;
- **baseline** — a JSON file of grandfathered findings, each carrying a
  mandatory human justification.  ``lint`` exits non-zero only on
  findings *not* in the baseline, so the gate ratchets: new debt fails
  the tests the commit it appears, old debt is documented, not hidden;
- **escape hatches** — ``# lint: ignore[rule-id] reason`` on the
  offending line suppresses one finding in place (rule-specific hatches
  such as ``# lock-free: reason`` are handled by their rules).

Run it as ``python -m fmda_tpu_torch lint [--json] [--rule ID]`` (exit
0 = clean vs baseline, 1 = new findings, 2 = usage error) or through
:func:`run_lint` in tests.  Lint reads source files on the host and
touches no device.
"""

from __future__ import annotations

import ast
import io
import json
import pathlib
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

#: the package under analysis (``fmda_tpu_torch/``)
PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent

#: grandfathered findings, shipped next to the engine so the gate is
#: self-contained wherever the package is checked out
DEFAULT_BASELINE = PACKAGE_DIR / "analysis" / "baseline.json"

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one site.

    ``message`` must be *stable* — no line numbers, no absolute paths —
    because ``(rule, path, message)`` is the baseline key that has to
    survive unrelated edits shifting the file around.
    """

    rule: str
    path: str  # posix path relative to the package dir
    line: int
    message: str
    severity: str = "warning"

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def format(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}/{self.severity}] "
                f"{self.message}")

    def as_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "severity": self.severity,
            "message": self.message,
        }


class ParsedModule:
    """One source file, parsed once and shared by every rule.

    ``comments`` maps line number → comment text (sans ``#``, stripped),
    extracted with :mod:`tokenize` so string literals containing ``#``
    never masquerade as comments — the escape hatches and ``guarded-by``
    annotations key on it.
    """

    __slots__ = ("path", "rel", "text", "tree", "comments")

    def __init__(self, path: str, rel: str, text: str, tree: ast.AST,
                 comments: Dict[int, str]) -> None:
        self.path = path
        self.rel = rel
        self.text = text
        self.tree = tree
        self.comments = comments

    @classmethod
    def from_source(cls, text: str,
                    rel: str = "<fixture>.py") -> "ParsedModule":
        """Parse from a source string — the fixture-test entry point."""
        tree = ast.parse(text, filename=rel)
        return cls(rel, rel, text, tree, _extract_comments(text))

    @classmethod
    def parse(cls, path: pathlib.Path,
              package_dir: pathlib.Path) -> "ParsedModule":
        text = path.read_text()
        rel = path.relative_to(package_dir).as_posix()
        tree = ast.parse(text, filename=str(path))
        return cls(str(path), rel, text, tree, _extract_comments(text))


def _extract_comments(text: str) -> Dict[int, str]:
    comments: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                comments[tok.start[0]] = tok.string.lstrip("#").strip()
    except tokenize.TokenError:  # a file ast accepts but tokenize trips
        pass  # on loses only its escape hatches, never its findings
    return comments


class LintContext:
    """Shared state for one lint run: the module cache plus a scratch
    space where rules park machine-readable side products (the torch
    drift inventory, the topic tables) for the CLI to export."""

    def __init__(self, package_dir: pathlib.Path,
                 modules: Sequence[ParsedModule]) -> None:
        self.package_dir = package_dir
        self.modules = list(modules)
        self.reports: Dict[str, object] = {}
        self._index = None

    def module(self, rel: str) -> Optional[ParsedModule]:
        for m in self.modules:
            if m.rel == rel:
                return m
        return None

    def index(self):
        """The whole-program :class:`~fmda_tpu_torch.analysis.program
        .ProgramIndex` (constants, function/counter catalog), built
        lazily on first use and shared by every rule in the run."""
        if self._index is None:
            from fmda_tpu_torch.analysis.program import ProgramIndex

            self._index = ProgramIndex(self.modules)
        return self._index


class Rule:
    """Base analyzer.  Subclasses set ``id``/``severity``/``description``
    and implement :meth:`check` (per module) and/or :meth:`finish`
    (after every module has been seen — whole-program rules)."""

    id: str = ""
    severity: str = "warning"
    description: str = ""
    #: ``False`` makes the rule a zero-baseline hard gate: its findings
    #: can never be grandfathered, and any baseline entry carrying its
    #: id is itself a gate failure (``LintResult.forbidden_baseline``).
    #: The drift rule runs this way — new API drift fails lint the
    #: commit it appears, no debt register.
    grandfatherable: bool = True

    def start(self) -> None:
        """Called before the run parses the tree (and again, harmlessly,
        before the rule's first check): a rule with a slow set-up starts
        it here, so it overlaps the other rules' work."""

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        return []

    def finish(self, ctx: LintContext) -> List[Finding]:
        return []

    def finding(self, module_rel: str, line: int, message: str,
                *, severity: Optional[str] = None) -> Finding:
        return Finding(self.id, module_rel, line, message,
                       severity or self.severity)


# ---------------------------------------------------------------------------
# Escape hatches
# ---------------------------------------------------------------------------

IGNORE_PREFIX = "lint: ignore["


def ignored_rules(module: ParsedModule, line: int) -> Dict[str, str]:
    """``{rule_id: reason}`` for a ``# lint: ignore[rule] reason`` hatch
    on ``line`` (or the line above, for sites too long to share a line).
    A hatch with an empty reason is inert — suppressions must say why.
    """
    out: Dict[str, str] = {}
    for ln in (line, line - 1):
        comment = module.comments.get(ln)
        if not comment or IGNORE_PREFIX not in comment:
            continue
        rest = comment.split(IGNORE_PREFIX, 1)[1]
        if "]" not in rest:
            continue
        rule_id, reason = rest.split("]", 1)
        reason = reason.strip().lstrip("—-: ").strip()
        if rule_id.strip() and reason:
            out[rule_id.strip()] = reason
    return out


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: Optional[pathlib.Path] = None) -> List[Dict[str, str]]:
    """Baseline entries (``rule``/``path``/``message``/``justification``).
    Every entry MUST carry a non-empty justification — a baseline is a
    documented debt register, not a mute button."""
    path = pathlib.Path(path) if path else DEFAULT_BASELINE
    if not path.is_file():
        return []
    doc = json.loads(path.read_text())
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: unknown version {doc.get('version')!r}")
    entries = doc.get("findings", [])
    for e in entries:
        for k in ("rule", "path", "message"):
            if not e.get(k):
                raise ValueError(f"baseline {path}: entry missing {k!r}: {e}")
        if not str(e.get("justification", "")).strip():
            raise ValueError(
                f"baseline {path}: entry for {e['rule']}:{e['path']} has no "
                "justification — grandfathered findings must say why")
    return entries


def save_baseline(entries: Sequence[Dict[str, str]],
                  path: pathlib.Path) -> None:
    doc = {
        "version": BASELINE_VERSION,
        "findings": sorted(
            ({k: e[k] for k in ("rule", "path", "message", "justification")}
             for e in entries),
            key=lambda e: (e["rule"], e["path"], e["message"])),
    }
    path.write_text(json.dumps(doc, indent=2) + "\n")


def apply_baseline(
    findings: Sequence[Finding], entries: Sequence[Dict[str, str]]
) -> Tuple[List[Finding], List[Finding], List[Dict[str, str]]]:
    """Split ``findings`` into (new, grandfathered) and report baseline
    entries that no longer match anything (stale — the debt was paid;
    prune them)."""
    keys = {(e["rule"], e["path"], e["message"]): e for e in entries}
    new: List[Finding] = []
    old: List[Finding] = []
    hit = set()
    for f in findings:
        if f.key in keys:
            old.append(f)
            hit.add(f.key)
        else:
            new.append(f)
    stale = [e for k, e in keys.items() if k not in hit]
    return new, old, stale


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


@dataclass
class LintResult:
    """Everything one run produced, pre-split against the baseline."""

    new: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    stale_baseline: List[Dict[str, str]] = field(default_factory=list)
    #: baseline entries for zero-baseline rules (``grandfatherable =
    #: False``) — forbidden debt: the gate fails until they are removed
    forbidden_baseline: List[Dict[str, str]] = field(default_factory=list)
    n_modules: int = 0
    reports: Dict[str, object] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        # stale/forbidden entries gate too: the CLI, the smoke's lint
        # phase and the tree test must agree — a paid-off debt left in the
        # baseline (or one smuggled under a zero-baseline rule) is a
        # red build everywhere, not a stderr whisper
        return (not self.new and not self.stale_baseline
                and not self.forbidden_baseline)

    def as_dict(self) -> Dict[str, object]:
        """The ``lint --json`` document.  Schema is load-bearing (CI
        parses it) and covered by a stability test — extend, don't
        rename."""
        return {
            "ok": self.ok,
            "n_modules": self.n_modules,
            "new": [f.as_dict() for f in self.new],
            "baselined": [f.as_dict() for f in self.baselined],
            "suppressed": self.suppressed,
            "stale_baseline": list(self.stale_baseline),
            "forbidden_baseline": list(self.forbidden_baseline),
            "reports": self.reports,
        }


def iter_module_files(package_dir: pathlib.Path) -> List[pathlib.Path]:
    return sorted(p for p in package_dir.rglob("*.py")
                  if "__pycache__" not in p.parts)


def collect_modules(package_dir: Optional[pathlib.Path] = None) -> LintContext:
    package_dir = package_dir or PACKAGE_DIR
    modules = [ParsedModule.parse(p, package_dir)
               for p in iter_module_files(package_dir)]
    return LintContext(package_dir, modules)


def run_rules(rules: Sequence[Rule],
              ctx: LintContext) -> Tuple[List[Finding], int]:
    """All findings from ``rules`` over ``ctx``, escape hatches already
    applied.  Returns ``(findings, n_suppressed)``."""
    findings: List[Finding] = []
    suppressed = 0
    by_rel = {m.rel: m for m in ctx.modules}
    for rule in rules:
        rule.start()
    for rule in rules:
        raw: List[Finding] = []
        for module in ctx.modules:
            raw.extend(rule.check(module, ctx))
        raw.extend(rule.finish(ctx))
        for f in raw:
            module = by_rel.get(f.path)
            # zero-baseline rules accept neither baseline entries nor
            # the inline hatch — a hard gate with an escape hatch is a
            # soft gate (their findings are reported, never suppressed)
            if (rule.grandfatherable and module is not None
                    and f.rule in ignored_rules(module, f.line)):
                suppressed += 1
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings, suppressed


def run_lint(
    rules: Optional[Sequence[Rule]] = None,
    *,
    package_dir: Optional[pathlib.Path] = None,
    baseline_path: Optional[pathlib.Path] = None,
    ctx: Optional[LintContext] = None,
) -> LintResult:
    """Parse once, run every rule, split against the baseline."""
    if rules is None:
        from fmda_tpu_torch.analysis import default_rules

        rules = default_rules()
    for rule in rules:
        rule.start()  # slow set-ups overlap the parse
    if ctx is None:
        ctx = collect_modules(package_dir)
    findings, suppressed = run_rules(rules, ctx)
    entries = load_baseline(baseline_path)
    # only consider baseline entries for rules that actually ran — a
    # --rule-filtered run must not report every other rule's entries
    # as stale debt
    ran = {r.id for r in rules}
    entries = [e for e in entries if e["rule"] in ran]
    # zero-baseline rules admit NO grandfathering: their entries never
    # match findings (so the findings stay new) and are reported as
    # forbidden debt that fails the gate until pruned
    hard = {r.id for r in rules if not r.grandfatherable}
    forbidden = [e for e in entries if e["rule"] in hard]
    entries = [e for e in entries if e["rule"] not in hard]
    new, old, stale = apply_baseline(findings, entries)
    return LintResult(
        new=new, baselined=old, suppressed=suppressed,
        stale_baseline=stale, forbidden_baseline=forbidden,
        n_modules=len(ctx.modules), reports=dict(ctx.reports),
    )
