"""Whole-program index: the engine's interprocedural support layer.

Most rules are module-local (one AST walk each); the never-abort
analyzers (counted loss, the wire protocol) need three whole-program
facts no single module shows:

- **who counts what** — a catalog of registered counter names harvested
  from ``MetricsRegistry`` registrations (``registry.counter("name")``)
  and ``RuntimeMetrics`` increments (``metrics.count("name")``), with
  per-site locations.  The accounting rule cross-checks the soak gates'
  loss vocabulary against it;
- **which functions increment a counter** — so an ``except`` handler
  that delegates its accounting to a one-level callee
  (``self._publish_control_counted(...)`` counts inside) is recognized
  without a hatch;
- **module-level string constants** — so a message-kind comparison
  against ``HELLO`` (defined once in ``fleet/membership.py``) resolves
  to ``"hello"``, and a kind produced by passing ``HELLO`` into a
  helper that stamps ``{"kind": kind}`` resolves the same way.

Built once per lint run (:meth:`LintContext.index`), shared by every
rule — the same one-parse discipline as :class:`ParsedModule`.  All
inferences are deliberately *over-approximations in the safe
direction*: treating any ``+= `` on an attribute as "counts" can only
suppress a finding (a human then reviews the hatchless site), never
invent one.

Pure AST, stdlib only — runs on hosts without torch.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

#: method names whose call means "a counter was incremented":
#: ``RuntimeMetrics.count``, ``Counter.inc`` (registry instruments and
#: the cached handles bound from ``registry.counter(...)``)
COUNT_METHODS = ("count", "inc")

#: method names whose literal first argument REGISTERS a counter name
#: (the catalog side): ``metrics.count("x")`` increments-and-names,
#: ``registry.counter("x")`` mints the instrument
CATALOG_METHODS = ("count", "counter")


def _first_str_arg(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def is_counter_increment(node: ast.AST) -> bool:
    """Does this single statement/expression increment a counter?

    Recognized shapes (the repo's whole tallying vocabulary):

    - ``X.count(...)`` / ``X.inc(...)`` method calls;
    - any ``target += n`` (``self.scrape_errors += 1``,
      ``corrupt += 1``, ``self.counts["malformed"] += 1``);
    - the dict-tally assign ``d[k] = d.get(k, 0) + n``.
    """
    if isinstance(node, ast.Call):
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr in COUNT_METHODS)
    if isinstance(node, ast.AugAssign):
        return isinstance(node.op, ast.Add)
    if isinstance(node, ast.Assign) and isinstance(node.value, ast.BinOp) \
            and isinstance(node.value.op, ast.Add):
        left = node.value.left
        return (isinstance(left, ast.Call)
                and isinstance(left.func, ast.Attribute)
                and left.func.attr == "get")
    return False


def subtree_increments_counter(node: ast.AST) -> bool:
    """Any counter increment anywhere under ``node``."""
    return any(is_counter_increment(sub) for sub in ast.walk(node))


def called_names(node: ast.AST) -> List[str]:
    """Bare names of everything called under ``node``: ``f(...)`` -> f,
    ``self.m(...)``/``x.m(...)`` -> m."""
    out: List[str] = []
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        if isinstance(sub.func, ast.Name):
            out.append(sub.func.id)
        elif isinstance(sub.func, ast.Attribute):
            out.append(sub.func.attr)
    return out


class FunctionInfo:
    """One function/method definition, indexed."""

    __slots__ = ("name", "rel", "node", "params", "counts")

    def __init__(self, name: str, rel: str, node: ast.AST,
                 params: Tuple[str, ...], counts: bool) -> None:
        self.name = name
        self.rel = rel
        self.node = node
        self.params = params
        #: the body increments a counter somewhere (any depth)
        self.counts = counts


class ProgramIndex:
    """Per-program call/attribute index + the registered-counter catalog.

    Accessed through :meth:`fmda_tpu_torch.analysis.engine.LintContext.index`
    — built lazily on first use and cached for the run.
    """

    def __init__(self, modules: Sequence) -> None:
        #: module-level ``NAME = "str"`` constants, program-wide (names
        #: like HELLO/TOPIC_X are unique by convention; last wins)
        self.constants: Dict[str, str] = {}
        #: rel -> bare function name -> definitions in that module
        self.functions: Dict[str, Dict[str, List[FunctionInfo]]] = {}
        #: counter name -> [(rel, line)] where it is registered or
        #: incremented by literal (``.count("x")`` / ``.counter("x")``)
        self.counter_sites: Dict[str, List[Tuple[str, int]]] = {}
        for m in modules:
            self._index_module(m)

    def _index_module(self, module) -> None:
        rel = module.rel
        by_name: Dict[str, List[FunctionInfo]] = {}
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                self.constants[node.targets[0].id] = node.value.value
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                params = tuple(a.arg for a in node.args.args)
                info = FunctionInfo(
                    node.name, rel, node, params,
                    subtree_increments_counter(node))
                by_name.setdefault(node.name, []).append(info)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in CATALOG_METHODS:
                name = _first_str_arg(node)
                if name is not None:
                    self.counter_sites.setdefault(name, []).append(
                        (rel, node.lineno))
        self.functions[rel] = by_name

    # -- queries -------------------------------------------------------------

    def resolve_constant(self, node: ast.AST) -> Optional[str]:
        """A string value for ``node``: a literal, or a Name/Attribute
        resolving to a module-level string constant anywhere in the
        program (``HELLO``, ``membership.HELLO``)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name is not None:
            return self.constants.get(name)
        return None

    def module_function(self, rel: str, name: str) -> Optional[FunctionInfo]:
        """First definition of bare ``name`` in module ``rel`` (the
        one-level-callee lookup: same-module resolution only — honest
        about what a name-based index can prove)."""
        infos = self.functions.get(rel, {}).get(name)
        return infos[0] if infos else None

    def callee_counts(self, rel: str, handler: ast.AST) -> bool:
        """Does any one-level same-module callee invoked under
        ``handler`` increment a counter in its own body?"""
        for name in called_names(handler):
            info = self.module_function(rel, name)
            if info is not None and info.counts:
                return True
        return False
