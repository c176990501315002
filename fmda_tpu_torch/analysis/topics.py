"""Bus topic-literal cross-check.

A typo'd topic string fails *silently* on most backends: InProcessBus
raises only at publish time on an undeclared topic, KafkaBus rejects it
per-call, and a consumer on the misspelled side simply never sees a
message.  Those failures surface as timeouts in e2e tests (or worse, in
production) instead of at commit time.  This rule closes the loop
statically: **every topic a package module publishes must be declared or
consumed somewhere** — in the ``TOPIC_*`` vocabulary of
``fmda_tpu_torch/config.py``, at a ``consumer()`` subscription, or via
``add_topic()`` (the dynamic-inbox path the fleet and chaos proxies
use).

What resolves:

- string literals (``bus.publish("prediction", ...)``);
- ``TOPIC_*`` constants and ``config.TOPIC_*`` attributes (the config
  vocabulary is parsed, not imported);
- prefix shapes: ``TOPIC_FLEET_TICKS_PREFIX + wid``,
  ``fleet_worker_topic(w)``, and f-strings with a literal head all
  reduce to their literal prefix, matched prefix-wise against declared
  prefixes;
- anything else (a variable, ``self._topic``) is dynamic and skipped —
  this rule exists to catch typo'd literals, not to prove routing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

CONFIG_MODULE = "config.py"

#: bus methods whose first argument is a published topic
PUBLISH_METHODS = ("publish", "publish_many")
#: bus methods whose first argument declares/subscribes a topic
CONSUME_METHODS = ("consumer", "add_topic")

#: helpers that mint a prefixed topic name: callable name -> the
#: TOPIC_* prefix constant they expand
PREFIX_HELPERS = {"fleet_worker_topic": "TOPIC_FLEET_TICKS_PREFIX"}


def _config_vocabulary(
        ctx: LintContext) -> Tuple[Dict[str, str], Dict[str, str]]:
    """``TOPIC_*`` constants from config.py: (literals, prefixes), each
    mapping constant name -> string value."""
    literals: Dict[str, str] = {}
    prefixes: Dict[str, str] = {}
    cfg = ctx.module(CONFIG_MODULE)
    if cfg is None:
        return literals, prefixes
    for node in cfg.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Name) and t.id.startswith("TOPIC_")):
            continue
        if isinstance(node.value, ast.Constant) and isinstance(
                node.value.value, str):
            if t.id.endswith("_PREFIX"):
                prefixes[t.id] = node.value.value
            else:
                literals[t.id] = node.value.value
    return literals, prefixes


class BusTopicRule(Rule):
    id = "bus-topics"
    severity = "error"
    description = ("every published topic literal must be declared in "
                   "the config vocabulary or consumed somewhere")

    def __init__(self) -> None:
        #: ("literal"|"prefix", value, rel, line)
        self._published: List[Tuple[str, str, str, int]] = []
        self._consumed_literals: set = set()
        self._consumed_prefixes: set = set()

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        literals, prefixes = _config_vocabulary(ctx)
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.args):
                continue
            meth = node.func.attr
            if meth not in PUBLISH_METHODS and meth not in CONSUME_METHODS:
                continue
            kind, value = self._topic_pattern(
                node.args[0], literals, prefixes)
            if kind == "dynamic":
                continue
            if meth in PUBLISH_METHODS:
                self._published.append((kind, value, module.rel, node.lineno))
            else:
                if kind == "literal":
                    self._consumed_literals.add(value)
                else:
                    self._consumed_prefixes.add(value)
        return []

    def finish(self, ctx: LintContext) -> List[Finding]:
        literals, prefixes = _config_vocabulary(ctx)
        declared = set(literals.values()) | self._consumed_literals
        declared_prefixes = set(prefixes.values()) | self._consumed_prefixes
        found: List[Finding] = []
        reported = set()
        for kind, value, rel, line in self._published:
            if kind == "literal":
                ok = value in declared or any(
                    value.startswith(p) for p in declared_prefixes)
            else:
                ok = value in declared_prefixes or any(
                    value.startswith(p) for p in declared_prefixes)
            if ok or (rel, value) in reported:
                continue
            reported.add((rel, value))
            what = "topic" if kind == "literal" else "topic prefix"
            found.append(self.finding(
                rel, line,
                f"{what} {value!r} is published but never declared in "
                "the config vocabulary or consumed anywhere"))
        ctx.reports["bus_topics"] = {
            "declared": sorted(set(literals.values())),
            "declared_prefixes": sorted(set(prefixes.values())),
            "consumed": sorted(self._consumed_literals),
            "published": sorted({v for _, v, _, _ in self._published}),
        }
        self._published = []
        self._consumed_literals = set()
        self._consumed_prefixes = set()
        return found

    # -- topic expression -> pattern ----------------------------------------

    def _topic_pattern(self, node: ast.AST, literals: Dict[str, str],
                       prefixes: Dict[str, str]) -> Tuple[str, str]:
        """Reduce a topic argument expression to ("literal", s),
        ("prefix", p) or ("dynamic", "")."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return "literal", node.value
        name: Optional[str] = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr  # config.TOPIC_X
        if name is not None:
            if name in literals:
                return "literal", literals[name]
            if name in prefixes:
                return "prefix", prefixes[name]
            return "dynamic", ""
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            kind, value = self._topic_pattern(node.left, literals, prefixes)
            if kind != "dynamic":
                return "prefix", value
            return "dynamic", ""
        if isinstance(node, ast.JoinedStr) and node.values:
            head = node.values[0]
            if isinstance(head, ast.Constant) and isinstance(
                    head.value, str) and head.value:
                return "prefix", head.value
            return "dynamic", ""
        if isinstance(node, ast.Call):
            fname = None
            if isinstance(node.func, ast.Name):
                fname = node.func.id
            elif isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            if fname in PREFIX_HELPERS:
                const = PREFIX_HELPERS[fname]
                if const in prefixes:
                    return "prefix", prefixes[const]
        return "dynamic", ""
