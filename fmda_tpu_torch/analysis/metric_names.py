"""Metric series-name cross-check.

A typo'd series name fails *silently*: the registry creates instruments
on first touch, collectors emit whatever ``name`` their sample dicts
carry, and the Prometheus renderer sanitises anything it cannot express
— so ``fmda_engine_emited_total`` simply becomes a second, forever-flat
family next to the real one, and a label-key typo (``topic`` vs
``stream``) splits one series into two that no dashboard joins.  This
rule closes the loop statically, mirroring the bus topic-literal rule
(:mod:`fmda_tpu_torch.analysis.topics`):

- **registration sites**: ``registry.counter("name", **labels)`` /
  ``.gauge(...)`` / ``.histogram(...)`` calls with a literal name and
  only keyword labels (a second *positional* argument means a
  :class:`RuntimeMetrics`-style value setter, which is a different
  vocabulary, derived at export by ``runtime_families``);
- **collector samples**: dict literals with literal ``"name"`` and
  ``"labels"`` keys — the family-collector shape every scrape-time
  collector emits;

and flags:

- names that would be **mangled at exposition** (characters outside the
  Prometheus grammar get substituted — two spellings could collide);
- names already carrying the ``fmda_`` prefix (the renderer prefixes at
  exposition: the scrape would read ``fmda_fmda_...``);
- one name registered as **two instrument kinds** (counter in one
  module, gauge in another — the exposition's ``# TYPE`` would flap by
  scrape order);
- one name used with **inconsistent label-key sets** across sites (the
  label-key-typo shape; the snapshot-time ``process`` label is applied
  uniformly and not a site-level key, so it never trips this).

Dynamic names (f-strings with computed heads, variables) are skipped —
this rule exists to catch typo'd literals, not to prove the vocabulary.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

#: registry instrument factory method names (fmda_tpu_torch.obs.registry)
INSTRUMENT_METHODS = ("counter", "gauge", "histogram")

#: the Prometheus grammar AFTER the ``fmda_`` prefix is applied — a
#: name outside it is silently substituted at exposition
_EXPOSABLE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


class MetricNamesRule(Rule):
    id = "metric-names"
    severity = "error"
    description = ("registered metric series names must be "
                   "exposition-safe, unprefixed, kind-unique, and "
                   "label-key consistent")

    def __init__(self) -> None:
        #: name -> kind -> [(rel, line)]
        self._kinds: Dict[str, Dict[str, List[Tuple[str, int]]]] = {}
        #: name -> label-key-set -> [(rel, line)]
        self._labels: Dict[str, Dict[Tuple[str, ...],
                                     List[Tuple[str, int]]]] = {}

    # -- collection ----------------------------------------------------------

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                self._collect_call(module, node)
            elif isinstance(node, ast.Dict):
                self._collect_sample(module, node)
        return []

    def _collect_call(self, module: ParsedModule, node: ast.Call) -> None:
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in INSTRUMENT_METHODS):
            return
        # exactly one positional (the name): RuntimeMetrics.gauge(name,
        # value) and StageTimer-style two-positional calls are a
        # different vocabulary (exported via runtime_families' derived
        # names, which are dynamic and skipped)
        if len(node.args) != 1:
            return
        name = self._literal(node.args[0])
        if name is None:
            return
        keys = tuple(sorted(
            kw.arg for kw in node.keywords if kw.arg is not None))
        if any(kw.arg is None for kw in node.keywords):
            # **labels splat: the key set is dynamic — skip the
            # label-consistency check for this site, keep the name
            keys = None
        kind = node.func.attr
        self._site(name, kind, keys, module.rel, node.lineno)

    def _collect_sample(self, module: ParsedModule, node: ast.Dict) -> None:
        """A collector sample literal: ``{"name": ..., "labels": ...}``."""
        fields: Dict[str, ast.AST] = {}
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                fields[k.value] = v
        if "name" not in fields or "labels" not in fields:
            return
        name = self._literal(fields["name"])
        if name is None:
            return  # f-string family names (runtime_families) are dynamic
        labels = fields["labels"]
        keys: Optional[Tuple[str, ...]] = None
        if isinstance(labels, ast.Dict):
            literal_keys = []
            dynamic = False
            for k in labels.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    literal_keys.append(k.value)
                else:
                    dynamic = True
            if not dynamic:
                keys = tuple(sorted(literal_keys))
        self._site(name, "sample", keys, module.rel, node.lineno)

    def _site(self, name: str, kind: str, keys: Optional[Tuple[str, ...]],
              rel: str, line: int) -> None:
        self._kinds.setdefault(name, {}).setdefault(kind, []).append(
            (rel, line))
        if keys is not None:
            self._labels.setdefault(name, {}).setdefault(keys, []).append(
                (rel, line))

    @staticmethod
    def _literal(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    # -- verdicts ------------------------------------------------------------

    def finish(self, ctx: LintContext) -> List[Finding]:
        found: List[Finding] = []
        for name in sorted(self._kinds):
            by_kind = self._kinds[name]
            rel, line = next(iter(by_kind.values()))[0]
            if not _EXPOSABLE.match(name):
                found.append(self.finding(
                    rel, line,
                    f"series name {name!r} is outside the Prometheus "
                    "grammar — exposition would silently substitute "
                    "characters (two spellings could collide)"))
            if name.startswith("fmda_"):
                found.append(self.finding(
                    rel, line,
                    f"series name {name!r} already carries the fmda_ "
                    "prefix — exposition prefixes again (the scrape "
                    "would read fmda_fmda_...)"))
            # one name, two instrument kinds: the exposition's # TYPE
            # would depend on sample order (collector "sample" sites
            # have no kind and never conflict)
            instrument_kinds = sorted(
                k for k in by_kind if k != "sample")
            if len(instrument_kinds) > 1:
                sites = "; ".join(
                    f"{k} at {by_kind[k][0][0]}" for k in instrument_kinds)
                found.append(self.finding(
                    rel, line,
                    f"series {name!r} is registered as multiple "
                    f"instrument kinds ({sites}) — the exposition "
                    "# TYPE cannot be both"))
        for name in sorted(self._labels):
            by_keys = self._labels[name]
            if len(by_keys) <= 1:
                continue
            rel, line = next(iter(by_keys.values()))[0]
            shapes = " vs ".join(
                "{" + ",".join(keys) + "}" for keys in sorted(by_keys))
            found.append(self.finding(
                rel, line,
                f"series {name!r} is used with inconsistent label-key "
                f"sets ({shapes}) — a label-key typo splits one series "
                "into unjoinable families"))
        ctx.reports["metric_names"] = {
            "n_names": len(self._kinds),
            "names": sorted(self._kinds),
        }
        self._kinds = {}
        self._labels = {}
        return found
