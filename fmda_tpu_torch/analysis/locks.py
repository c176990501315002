"""Lock-discipline race detector.

The serving stack is threaded end to end — gateway pumps, bus server
accept loops, metrics scrapes, tracer rings — and its convention is one
``self._lock`` (or ``_*lock``) per shared object with every mutation of
shared state inside ``with self._lock:``.  This rule makes that
convention checkable:

An attribute is **guarded** when

- its assignment carries a ``# guarded-by: _lock`` annotation, or
- any method of the class (``__init__`` aside) *writes* it inside a
  ``with self.<lock>:`` block — if one writer needed the lock, every
  other access is a suspect until proven deliberate.

Every read or write of a guarded attribute outside a lock scope is a
finding.  Deliberate lock-free fast paths declare themselves with
``# lock-free: <reason>`` on the access line (an empty reason is inert
— suppressions must say why), or are grandfathered into the baseline
with a justification.

Scope and honesty about what static analysis can see:

- ``__init__``/``__new__`` are exempt (construction happens-before
  publication to other threads);
- methods named ``*_locked`` are callee-side contracts ("caller holds
  the lock"): their bodies are treated as guarded, and *calling* one
  outside a lock scope is itself a finding;
- lock scopes are tracked lexically, so a closure defined inside a
  ``with`` block is treated as guarded even though it may run later —
  the cheap, predictable over-approximation.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

#: attribute names that hold a mutex: _lock, _big_lock, ...
LOCK_ATTR_RE = re.compile(r"^_\w*lock$")
GUARDED_BY_RE = re.compile(r"guarded-by:\s*(\w+)")
LOCK_FREE_RE = re.compile(r"lock-free:\s*(\S.*)")

#: attribute stores that never count as shared-state mutation
_EXEMPT_ATTRS = ("__dict__",)

#: method names that mutate their receiver in place — a call to
#: ``self.X.append(...)`` under the lock marks ``X`` guarded exactly
#: like ``self.X = ...`` does (most of the repo's shared state is
#: dicts/deques/lists mutated through these, not rebound)
_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "popitem", "clear", "add", "discard", "update",
    "setdefault", "sort", "reverse", "write", "writelines", "flush",
})


def _self_attr(node: ast.AST) -> Optional[str]:
    """``X`` for an ``self.X`` attribute node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _base_self_attr(node: ast.AST) -> Optional[str]:
    """``X`` for ``self.X`` reached through any subscript chain
    (``self.X[k]``, ``self.X[k][j]``), else None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return _self_attr(node)


def _with_locks(node: ast.With, locks: Set[str]) -> bool:
    """True when any item of the with statement acquires a class lock."""
    for item in node.items:
        attr = _self_attr(item.context_expr)
        if attr is not None and attr in locks:
            return True
    return False


class _ClassInfo:
    def __init__(self, node: ast.ClassDef) -> None:
        self.node = node
        self.locks: Set[str] = set()
        #: guarded attribute -> lock name that guards it
        self.guarded: Dict[str, str] = {}
        #: attrs annotated guarded explicitly (never inferred away)
        self.annotated: Set[str] = set()


def _methods(cls: ast.ClassDef):
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield item


def _exempt_method(name: str) -> bool:
    return name in ("__init__", "__new__") or name.endswith("_locked")


class LockDisciplineRule(Rule):
    id = "lock-discipline"
    severity = "warning"
    description = ("lock-guarded attributes must be read/written inside "
                   "`with self._lock:` (escape hatch: `# lock-free: reason`)")

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        found: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                found.extend(self._check_class(module, node))
        return found

    # -- per-class passes ---------------------------------------------------

    def _check_class(self, module: ParsedModule,
                     cls: ast.ClassDef) -> List[Finding]:
        info = _ClassInfo(cls)
        self._collect_locks(info)
        if not info.locks:
            return []
        self._collect_guarded(module, info)
        if not info.guarded:
            return []
        return self._collect_violations(module, info)

    def _collect_locks(self, info: _ClassInfo) -> None:
        for meth in _methods(info.node):
            for node in ast.walk(meth):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr is not None and LOCK_ATTR_RE.match(attr):
                            info.locks.add(attr)

    def _collect_guarded(self, module: ParsedModule, info: _ClassInfo) -> None:
        # explicit `# guarded-by: _lock` annotations, anywhere in the class
        for meth in _methods(info.node):
            for node in ast.walk(meth):
                if not isinstance(node, (ast.Assign, ast.AnnAssign,
                                         ast.AugAssign)):
                    continue
                comment = module.comments.get(node.lineno, "")
                m = GUARDED_BY_RE.search(comment)
                if not m:
                    continue
                lock = m.group(1)
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        info.guarded[attr] = lock
                        info.annotated.add(attr)
        # inferred: attributes written under a lock in any non-exempt method
        for meth in _methods(info.node):
            if _exempt_method(meth.name):
                continue
            self._infer_walk(meth.body, info, held=None)
        for lock in info.locks:
            info.guarded.pop(lock, None)

    def _infer_walk(self, body, info: _ClassInfo,
                    held: Optional[str]) -> None:
        for node in body:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and attr in info.locks:
                        inner = attr
                self._infer_walk(node.body, info, inner)
                continue
            if held is not None:
                for sub in ast.walk(node):
                    attr = self._stored_attr(sub)
                    if attr is not None and attr not in info.annotated:
                        info.guarded.setdefault(attr, held)
            # recurse into compound statements, keeping the held state
            for child_body in self._child_bodies(node):
                self._infer_walk(child_body, info, held)

    @staticmethod
    def _child_bodies(node: ast.AST):
        for attr in ("body", "orelse", "finalbody"):
            sub = getattr(node, attr, None)
            if sub and isinstance(sub, list):
                yield sub
        for h in getattr(node, "handlers", []) or []:
            yield h.body
        for case in getattr(node, "cases", []) or []:  # ast.Match
            yield case.body

    @staticmethod
    def _stored_attr(node: ast.AST) -> Optional[str]:
        """``X`` when this node mutates ``self.X``: a plain/aug store, a
        subscript store (``self.X[k] = ...``, ``self.X[k] += ...``,
        ``del self.X[k]``), or an in-place mutator call
        (``self.X.append(...)``)."""
        if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            attr = _self_attr(node)
            if attr is not None and attr not in _EXEMPT_ATTRS:
                return attr
        if isinstance(node, ast.AugAssign):
            return _base_self_attr(node.target)
        if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, (ast.Store, ast.Del)):
            return _base_self_attr(node.value)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATOR_METHODS):
            return _base_self_attr(node.func.value)
        return None

    # -- violation pass -----------------------------------------------------

    def _collect_violations(self, module: ParsedModule,
                            info: _ClassInfo) -> List[Finding]:
        found: List[Finding] = []
        seen: Set[Tuple[str, str, str, str]] = set()

        def emit(meth: str, line: int, attr: str, kind: str) -> None:
            key = (info.node.name, meth, attr, kind)
            if key in seen:
                return  # one finding per (method, attr, kind) site family
            for ln in (line, line - 1):
                if LOCK_FREE_RE.search(module.comments.get(ln, "")):
                    # declared-deliberate lock-free access; the hatch
                    # covers every same-shaped access in this method
                    seen.add(key)
                    return
            seen.add(key)
            lock = info.guarded.get(attr, "_lock")
            found.append(self.finding(
                module.rel, line,
                f"{info.node.name}.{meth}: {kind} self.{attr} outside "
                f"`with self.{lock}:` (lock-guarded attribute)"))

        def walk(body, meth: str, held: bool) -> None:
            for node in body:
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    inner = held or _with_locks(node, info.locks)
                    for item in node.items:
                        self._scan_expr(item.context_expr, module, info,
                                        meth, held, emit)
                    walk(node.body, meth, inner)
                    continue
                if not held:
                    self._scan_stmt(node, module, info, meth, emit)
                for child_body in self._child_bodies(node):
                    walk(child_body, meth, held)

        for meth in _methods(info.node):
            if _exempt_method(meth.name):
                continue
            walk(meth.body, meth.name, False)
        return found

    def _scan_stmt(self, node: ast.AST, module, info, meth, emit) -> None:
        """Flag guarded-attribute touches in this statement, skipping
        nested compound bodies (the caller recurses into those with the
        right held state)."""
        skip = set()
        for child_body in self._child_bodies(node):
            for sub in child_body:
                skip.update(ast.walk(sub))
        for sub in ast.walk(node):
            if sub in skip:
                continue
            self._scan_node(sub, module, info, meth, emit)

    def _scan_expr(self, expr: ast.AST, module, info, meth, held,
                   emit) -> None:
        if held:
            return
        for sub in ast.walk(expr):
            self._scan_node(sub, module, info, meth, emit)

    def _scan_node(self, sub: ast.AST, module, info, meth, emit) -> None:
        if isinstance(sub, ast.Attribute):
            attr = _self_attr(sub)
            if attr is None:
                return
            if attr in info.guarded:
                kind = ("write to" if isinstance(
                    sub.ctx, (ast.Store, ast.Del)) else "read of")
                emit(meth, sub.lineno, attr, kind)
            elif attr.endswith("_locked") and isinstance(sub.ctx, ast.Load):
                emit(meth, sub.lineno, attr, "call to")
        elif isinstance(sub, ast.AugAssign):
            attr = _self_attr(sub.target)
            if attr is not None and attr in info.guarded:
                emit(meth, sub.lineno, attr, "write to")
