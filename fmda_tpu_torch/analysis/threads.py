"""thread-lifecycle: every spawned thread is daemonized or joined.

A non-daemon thread nobody joins keeps the interpreter alive after
``main`` returns — a hung teardown in production and an eaten timeout
in every test run (the BusServer ``accept()`` stall that once cost
a test run ~300 s of wall clock was exactly this class).  A *daemon* thread
is the sanctioned fire-and-forget shape; a non-daemon one is a promise
that some owner joins (or, for ``threading.Timer``, cancels) it on a
close path.  This rule checks the promise statically:

every ``threading.Thread(...)`` / ``threading.Timer(...)`` construction
in the package must either

- pass ``daemon=True`` at the constructor (or set ``<target>.daemon =
  True`` on the assigned name before ``start()``), or
- be assigned to ``self.<attr>`` in a class one of whose methods calls
  ``self.<attr>.join(...)`` / ``.cancel(...)`` — the owner's close
  path; a local variable must be joined/cancelled in the same function.

Deliberate exceptions annotate in place
(``# lint: ignore[thread-lifecycle] reason``).  Lexical, class-local
reasoning — the honest static approximation: a thread handed to
another object to join is out of scope and should say so with the
hatch.  Pure AST; stdlib only.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

SPAWN_CLASSES = ("Thread", "Timer")

#: methods that settle a thread's lifecycle on the owner's close path
SETTLE_METHODS = ("join", "cancel")


def _spawn_class(node: ast.Call, mod_aliases: Set[str],
                 name_aliases: Dict[str, str]) -> Optional[str]:
    """``"Thread"``/``"Timer"`` when ``node`` constructs one, resolved
    through ``import threading [as t]`` and ``from threading import
    Thread [as T]``."""
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in SPAWN_CLASSES \
            and isinstance(fn.value, ast.Name) \
            and fn.value.id in mod_aliases:
        return fn.attr
    if isinstance(fn, ast.Name):
        return name_aliases.get(fn.id)
    return None


def _daemon_kwarg(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


def _assigned_target(parent_assign) -> Optional[ast.AST]:
    if isinstance(parent_assign, ast.AnnAssign):
        return parent_assign.target
    if parent_assign is None or len(parent_assign.targets) != 1:
        return None
    return parent_assign.targets[0]


class ThreadLifecycleRule(Rule):
    id = "thread-lifecycle"
    severity = "error"
    description = ("threading.Thread/Timer constructions are daemonized or "
                   "provably joined/cancelled on the owner's close path")

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        mod_aliases: Set[str] = set()
        #: local name -> spawn class ("Thread"/"Timer") for from-imports
        name_aliases: Dict[str, str] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "threading":
                        mod_aliases.add(a.asname or "threading")
            elif isinstance(node, ast.ImportFrom) \
                    and node.module == "threading":
                for a in node.names:
                    if a.name in SPAWN_CLASSES:
                        name_aliases[a.asname or a.name] = a.name
        if not mod_aliases and not name_aliases:
            return []
        found: List[Finding] = []
        #: Call node -> (enclosing function, enclosing class, Assign)
        context = self._spawn_context(module.tree)
        for node, (func, cls, assign) in context.items():
            spawned = _spawn_class(node, mod_aliases, name_aliases)
            if spawned is None or _daemon_kwarg(node):
                continue
            target = _assigned_target(assign)
            scope = (f"{cls.name}.{func.name}" if cls and func
                     else func.name if func else "<module>")
            settle = "/".join(SETTLE_METHODS)
            if isinstance(target, ast.Attribute) \
                    and isinstance(target.value, ast.Name) \
                    and target.value.id == "self" and cls is not None:
                if self._class_settles(cls, target.attr) \
                        or self._daemon_set(cls, "self", target.attr):
                    continue
                found.append(self.finding(
                    module.rel, node.lineno,
                    f"{scope}: non-daemon {spawned} stored to "
                    f"self.{target.attr} is never {settle}ed by any "
                    f"method of {cls.name} — daemonize it or settle it "
                    "on the close path"))
            elif isinstance(target, ast.Name) and func is not None:
                if self._func_settles(func, target.id) \
                        or self._daemon_set(func, None, target.id):
                    continue
                found.append(self.finding(
                    module.rel, node.lineno,
                    f"{scope}: non-daemon {spawned} bound to "
                    f"`{target.id}` is never {settle}ed in this "
                    "function — daemonize it or settle it before "
                    "returning"))
            else:
                found.append(self.finding(
                    module.rel, node.lineno,
                    f"{scope}: non-daemon {spawned} is fire-and-forget "
                    "(never bound, so nothing can ever join it) — "
                    "daemonize it"))
        return found

    # -- context / ownership resolution --------------------------------------

    @staticmethod
    def _spawn_context(tree: ast.AST) -> Dict[ast.Call, tuple]:
        """Every Call node mapped to (function, class, direct Assign)."""
        out: Dict[ast.Call, tuple] = {}

        def walk(node, func, cls, assign):
            for child in ast.iter_child_nodes(node):
                c_func, c_cls, c_assign = func, cls, assign
                if isinstance(child, ast.ClassDef):
                    c_cls, c_func = child, None
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    c_func = child
                elif isinstance(child, (ast.Assign, ast.AnnAssign)):
                    c_assign = child
                elif not isinstance(child, (ast.expr, ast.keyword)):
                    c_assign = None
                if isinstance(child, ast.Call):
                    out[child] = (c_func, c_cls, c_assign)
                walk(child, c_func, c_cls, c_assign)

        walk(tree, None, None, None)
        return out

    @staticmethod
    def _settle_calls(tree: ast.AST, base: Optional[str], attr: str) -> bool:
        """Any ``<base>.<attr>.join()``/``.cancel()`` under ``tree``
        (``base=None`` means a bare local name)."""
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in SETTLE_METHODS):
                continue
            owner = node.func.value
            if base is None:
                if isinstance(owner, ast.Name) and owner.id == attr:
                    return True
            elif isinstance(owner, ast.Attribute) and owner.attr == attr \
                    and isinstance(owner.value, ast.Name) \
                    and owner.value.id == base:
                return True
        return False

    def _class_settles(self, cls: ast.ClassDef, attr: str) -> bool:
        return self._settle_calls(cls, "self", attr)

    @staticmethod
    def _daemon_set(tree: ast.AST, base: Optional[str], attr: str) -> bool:
        """``<target>.daemon = True`` anywhere in the owner scope."""
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and node.targets[0].attr == "daemon"
                    and isinstance(node.value, ast.Constant)
                    and node.value.value is True):
                continue
            owner = node.targets[0].value
            if base is None:
                if isinstance(owner, ast.Name) and owner.id == attr:
                    return True
            elif isinstance(owner, ast.Attribute) and owner.attr == attr \
                    and isinstance(owner.value, ast.Name) \
                    and owner.value.id == base:
                return True
        return False

    def _func_settles(self, func: ast.AST, name: str) -> bool:
        return self._settle_calls(func, None, name)
