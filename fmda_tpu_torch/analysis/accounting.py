"""counted-loss: the never-abort contract as a checked property.

The chaos and pipeline soaks enforce conservation *dynamically*:
``submitted == served + Σ counted losses`` (fmda_tpu_torch.chaos.soak)
and ``ingested == landed + Σ counted losses``
(fmda_tpu_torch.chaos.pipeline).
But a soak only samples the paths its fault plan happens to hit — a new
``except Exception: pass`` anywhere on the data plane silently breaks
conservation until a soak trips over it.  This rule makes the
discipline static, in two parts:

**Handler accounting.**  Every ``except`` handler in the hot packages
(``fleet/``, ``runtime/``, ``stream/``, ``chaos/``, ``obs/``) must do
one of:

- **re-raise** (any ``raise`` in the handler body — converting to a
  domain error counts, the failure stays loud);
- **increment a registered counter**, directly (``metrics.count(...)``,
  ``counter.inc(...)``, ``self.errors += 1``, the ``d[k] = d.get(k,0)+1``
  tally) or via a **one-level same-module callee** that counts in its
  own body (``self._publish_control_counted(...)``) — resolved through
  the whole-program index (:mod:`fmda_tpu_torch.analysis.program`);
- declare itself loss-free in place: ``# loss-free: <reason>`` on the
  ``except`` line or the line above.  An empty reason is inert —
  suppressions must say why, same contract as ``# lock-free:``.

**Conservation vocabulary cross-check** (the ``topics.py`` move,
applied to loss counters).  The gates declare which counters they sum —
``LOSS_COUNTERS`` in ``chaos/soak.py``, ``ROUTER_LOSS_COUNTERS`` /
``GATEWAY_LOSS_COUNTERS`` / ``QUALITY_LOSS_COUNTERS`` in
``obs/aggregate.py`` — and this rule harvests those tuples (parsed,
not imported) and checks both ways:

- a vocabulary entry **no code ever counts** is a dead gate term (the
  identity silently weakens) — finding on the declaring line;
- a **drop site** in a conservation-domain module (``fleet/router.py``
  for the fleet identity, ``runtime/gateway.py`` for the in-process
  one, ``obs/quality.py`` for the label-join capture ledger) counting
  into a loss-shaped counter the gate never sums is a
  leak in the identity — finding at the increment, unless annotated
  (``# lint: ignore[counted-loss] reason``) for counters that are
  deliberately outside it (e.g. ``routed_ticks_lost`` pre-counts ticks
  that later age into ``results_missing`` — summing both would double
  count).

Pure AST + the shared program index; stdlib only.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)
from fmda_tpu_torch.analysis.program import subtree_increments_counter

#: packages whose except handlers must account (the data/control plane
#: the soak gates cover)
SCOPE_PREFIXES = ("fleet/", "runtime/", "stream/", "chaos/", "obs/")

LOSS_FREE_RE = re.compile(r"loss-free:\s*(\S.*)")

#: counter names that denote a discarded unit of work
LOSS_NAME_RE = re.compile(r"lost|shed|missing|dropped|expired")

#: modules declaring the gates' loss vocabularies: rel -> constant-name
#: regex for the tuples to harvest there
VOCABULARY_MODULES = {
    "chaos/soak.py": re.compile(r"^LOSS_COUNTERS$"),
    "obs/aggregate.py": re.compile(
        r"^(ROUTER|GATEWAY|QUALITY)_LOSS_COUNTERS$"),
}

#: conservation domains: module whose counters a gate sums -> the
#: vocabulary constants that define its identity
CONSERVATION_DOMAINS = {
    "fleet/router.py": ("LOSS_COUNTERS", "ROUTER_LOSS_COUNTERS"),
    "runtime/gateway.py": ("GATEWAY_LOSS_COUNTERS",),
    "obs/quality.py": ("QUALITY_LOSS_COUNTERS",),
}


def _handler_exc_label(handler: ast.ExceptHandler) -> str:
    if handler.type is None:
        return "bare except"
    try:
        return f"except {ast.unparse(handler.type)}"
    except Exception:  # pragma: no cover - unparse is total on py>=3.9
        return "except <?>"


def _enclosing_scopes(tree: ast.AST) -> Dict[ast.AST, str]:
    """Map every node to its enclosing function qualname (dotted)."""
    scopes: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, qual: str) -> None:
        for child in ast.iter_child_nodes(node):
            child_qual = qual
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_qual = f"{qual}.{child.name}" if qual else child.name
            scopes[child] = child_qual
            walk(child, child_qual)

    walk(tree, "")
    return scopes


class CountedLossRule(Rule):
    id = "counted-loss"
    severity = "warning"
    description = ("hot-path except handlers re-raise, count a registered "
                   "counter, or carry `# loss-free: reason`; loss counters "
                   "cross-check against the soak gates' vocabulary")

    def __init__(self) -> None:
        #: loss-shaped counter increments seen in conservation-domain
        #: modules: (counter, rel, line)
        self._domain_losses: List[Tuple[str, str, int]] = []

    # -- per-module: handler accounting --------------------------------------

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        rel = module.rel
        if not rel.startswith(SCOPE_PREFIXES):
            return []
        index = ctx.index()
        scopes = _enclosing_scopes(module.tree)
        found: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Try):
                continue
            for handler in node.handlers:
                if self._loss_free(module, handler.lineno):
                    continue
                if any(isinstance(sub, ast.Raise)
                       for sub in ast.walk(handler)):
                    continue
                if subtree_increments_counter(handler):
                    continue
                if index.callee_counts(rel, handler):
                    continue
                scope = scopes.get(handler) or "<module>"
                found.append(self.finding(
                    rel, handler.lineno,
                    f"{scope}: `{_handler_exc_label(handler)}` swallows "
                    "without accounting — re-raise, increment a "
                    "registered counter, or annotate "
                    "`# loss-free: reason`"))
        if rel in CONSERVATION_DOMAINS:
            self._collect_domain_losses(module)
        return found

    @staticmethod
    def _loss_free(module: ParsedModule, line: int) -> bool:
        """The ``# loss-free: reason`` hatch: on the ``except`` line
        itself, or anywhere in the contiguous block of COMMENT-ONLY
        lines directly above it (handler annotations read better
        wrapped).  Trailing comments on *code* lines stop the upward
        walk — a previous handler's same-line hatch (or a stale marker
        on the last try-body statement) must never bleed down and
        exempt the next handler."""
        if LOSS_FREE_RE.search(module.comments.get(line, "")):
            return True
        lines = module.text.splitlines()
        ln = line - 1
        while (ln in module.comments and 0 < ln <= len(lines)
               and lines[ln - 1].lstrip().startswith("#")):
            if LOSS_FREE_RE.search(module.comments[ln]):
                return True
            ln -= 1
        return False

    def _collect_domain_losses(self, module: ParsedModule) -> None:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "count"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if LOSS_NAME_RE.search(name):
                self._domain_losses.append((name, module.rel, node.lineno))

    # -- whole-program: the vocabulary cross-check ---------------------------

    def _vocabularies(self, ctx: LintContext) -> Dict[str, Tuple[tuple, int]]:
        """``constant name -> ((counter names...), declaring line)``,
        harvested from the gate modules' tuple literals."""
        out: Dict[str, Tuple[tuple, int]] = {}
        for rel, name_re in VOCABULARY_MODULES.items():
            module = ctx.module(rel)
            if module is None:
                continue
            for node in module.tree.body:
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and name_re.match(node.targets[0].id)
                        and isinstance(node.value, (ast.Tuple, ast.List))):
                    continue
                names = tuple(
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
                out[node.targets[0].id] = (names, node.lineno)
        return out

    def finish(self, ctx: LintContext) -> List[Finding]:
        index = ctx.index()
        vocabs = self._vocabularies(ctx)
        found: List[Finding] = []
        # 1) dead gate terms: summed by a gate, counted by no one
        for const, (names, line) in sorted(vocabs.items()):
            rel = next(r for r, pat in VOCABULARY_MODULES.items()
                       if pat.match(const))
            for name in names:
                if name not in index.counter_sites:
                    found.append(self.finding(
                        rel, line,
                        f"conservation vocabulary entry {name!r} "
                        f"({const}) is summed by the gate but never "
                        "counted anywhere — a dead term weakens the "
                        "identity", severity="error"))
        # 2) drop sites outside the identity (one finding per site, so
        # each deliberate exception annotates itself in place)
        for name, rel, line in self._domain_losses:
            domain_vocab: set = set()
            for const in CONSERVATION_DOMAINS.get(rel, ()):
                domain_vocab.update(vocabs.get(const, ((), 0))[0])
            if name in domain_vocab:
                continue
            found.append(self.finding(
                rel, line,
                f"drop site counts into {name!r}, which the conservation "
                "gate never sums — add it to the gate vocabulary or "
                "annotate why it is outside the identity"))
        ctx.reports["counted_loss"] = {
            "vocabulary": {c: list(v[0]) for c, v in sorted(vocabs.items())},
            # the pipeline gate's loss fields are REPORT keys over
            # engine/journal stats, not counter names — carried for the
            # operators, exempt from the counter cross-checks
            "pipeline_loss_fields": list(
                self._pipeline_fields(ctx)),
            "registered_counters": sorted(index.counter_sites),
        }
        self._domain_losses = []
        return found

    @staticmethod
    def _pipeline_fields(ctx: LintContext) -> Tuple[str, ...]:
        module = ctx.module("chaos/pipeline.py")
        if module is None:
            return ()
        for node in module.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "PIPELINE_LOSS_FIELDS"
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                return tuple(
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
        return ()
