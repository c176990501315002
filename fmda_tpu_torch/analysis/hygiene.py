"""The package's hygiene checks, as engine rules.

``python -m fmda_tpu_torch lint`` enforces them alongside the race,
accounting and drift analyzers: a violation fails the tests the commit
it appears in.

- :class:`LoggingHygieneRule` — no ``print()``, no loggers outside the
  ``fmda_tpu_torch`` namespace (allowlist: the command line,
  ``__main__.py`` and ``obs/report.py``);
- :class:`SpanClockRule` — span-recording code never calls
  ``time.time()`` (monotonic ``perf_counter_ns`` only — an NTP step
  must not fold a trace back on itself);
- :class:`RouterTorchImportRule` — router-role fleet modules import
  neither torch nor jax at module scope (a fleet router runs on a
  bus-only host; the runtime subprocess half of the contract is
  ``tests/test_torch_isolation.py``'s import probe);
- :class:`ChaosGuardRule` — every ``_CHAOS`` injection-point touch sits
  under an ``if _CHAOS.enabled:`` guard (disabled chaos = one branch,
  zero allocation), and the instrumented modules keep their points.

Each rule also polices its own allowlist/module-list for staleness: a
refactor that moves a listed file must shrink the list, not silently
stop checking a path that no longer exists.
"""

from __future__ import annotations

import ast
from typing import Dict, List

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

#: modules whose prints are their contract, relative to the package root:
#: the command line (``__main__.py``, and ``obs/report.py`` with the
#: status/trace/perf/quality commands)
PRINT_ALLOWLIST = ("__main__.py", "obs/report.py")

LOGGER_NAMESPACE = "fmda_tpu_torch"

#: span-recording code — everywhere span timestamps are minted
SPAN_CODE = ("obs/trace.py",)

#: router-role fleet modules: a fleet router runs on a bus-only host, so
#: NOTHING on its import path may pull torch (or jax) in at module scope —
#: only worker.py (which embeds the serving runtime) may
ROUTER_ROLE_MODULES = (
    "fleet/__init__.py",
    "fleet/hashring.py",
    "fleet/launcher.py",
    "fleet/membership.py",
    "fleet/router.py",
    "fleet/state.py",
    "fleet/wire.py",
)

#: modules carrying compiled-in chaos injection points, with the
#: per-module floor of guarded ``if _CHAOS.enabled:`` sites each must
#: keep (serving tier: router.pump / wire.request / link exchanges /
#: worker.step; data plane: engine.step / warehouse.append /
#: feed:<topic>).  A refactor that drops a module below its floor fails
#: lint the commit it lands.
CHAOS_POINT_FLOORS = {
    "fleet/router.py": 1,
    "fleet/wire.py": 1,
    "fleet/worker.py": 1,
    "stream/engine.py": 1,
    "stream/warehouse.py": 1,
    "ingest/session.py": 1,
}
CHAOS_INSTRUMENTED = tuple(CHAOS_POINT_FLOORS)

#: the chaos modules together must keep at least this many guarded points
CHAOS_MIN_POINTS = 7


def _stale_entries(rule: Rule, ctx: LintContext, rels, list_name: str
                   ) -> List[Finding]:
    found = []
    for rel in rels:
        if not (ctx.package_dir / rel).is_file():
            found.append(rule.finding(
                rel, 0, f"stale {list_name} entry: {rel} does not exist",
                severity="error"))
    return found


class LoggingHygieneRule(Rule):
    """Library code reports through the obs plane or the
    ``fmda_tpu_torch`` logger hierarchy — never ``print()`` (invisible to
    log collectors, corrupts CLI JSON output), never a foreign logger."""

    id = "logging-hygiene"
    severity = "error"
    description = ("no print() and no loggers outside the fmda_tpu_torch "
                   "namespace in library code")

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        if module.rel in PRINT_ALLOWLIST:
            return []
        found: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "print":
                found.append(self.finding(
                    module.rel, node.lineno, "print() call"))
            is_get_logger = (
                isinstance(fn, ast.Attribute) and fn.attr == "getLogger"
            ) or (isinstance(fn, ast.Name) and fn.id == "getLogger")
            if is_get_logger:
                if not node.args:
                    found.append(self.finding(
                        module.rel, node.lineno,
                        "getLogger() with no name (the root logger is "
                        "not ours to configure)"))
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str):
                    name = arg.value
                    if name != LOGGER_NAMESPACE and not name.startswith(
                            LOGGER_NAMESPACE + "."):
                        found.append(self.finding(
                            module.rel, node.lineno,
                            f"logger {name!r} outside the "
                            f"{LOGGER_NAMESPACE!r} namespace"))
                elif isinstance(arg, ast.Name) and arg.id == "__name__":
                    pass  # module __name__ always resolves in the package
                else:
                    found.append(self.finding(
                        module.rel, node.lineno,
                        "getLogger() with a dynamic name — use a literal "
                        f"'{LOGGER_NAMESPACE}.*' name"))
        return found

    def finish(self, ctx: LintContext) -> List[Finding]:
        return _stale_entries(self, ctx, PRINT_ALLOWLIST, "allowlist")


class SpanClockRule(Rule):
    """Span timestamps come from ``time.perf_counter_ns`` — monotonic
    and ns-resolution, so a mid-run NTP step can never make stage
    durations negative.  ``time.time()`` in span code is a bug."""

    id = "span-wall-clock"
    severity = "error"
    description = "span-recording code must never call time.time()"

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        if module.rel not in SPAN_CODE:
            return []
        found: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (isinstance(fn, ast.Attribute) and fn.attr == "time"
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in ("time", "_time")):
                found.append(self.finding(
                    module.rel, node.lineno, "time.time() call"))
            elif isinstance(fn, ast.Name) and fn.id == "time":
                found.append(self.finding(
                    module.rel, node.lineno, "bare time() call"))
        if "perf_counter_ns" not in module.text:
            found.append(self.finding(
                module.rel, 0,
                "span code lost its perf_counter_ns clock"))
        return found

    def finish(self, ctx: LintContext) -> List[Finding]:
        return _stale_entries(self, ctx, SPAN_CODE, "SPAN_CODE")


#: frameworks a router-role module may not import at module scope
ROUTER_FORBIDDEN_ROOTS = ("torch", "jax")


class RouterTorchImportRule(Rule):
    """AST half of the bus-only-host contract: no router-role fleet
    module imports torch or jax (or a submodule) at module scope.
    Deferred imports inside function bodies are the sanctioned pattern;
    the transitive-import runtime half is the subprocess probe in
    ``tests/test_torch_isolation.py``.
    """

    id = "router-torch-import"
    severity = "error"
    description = ("router-role fleet modules must not import torch or "
                   "jax at module scope")

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        if module.rel not in ROUTER_ROLE_MODULES:
            return []
        found: List[Finding] = []

        def walk(body):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # deferred imports are the sanctioned pattern
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        if alias.name.split(".")[0] in \
                                ROUTER_FORBIDDEN_ROOTS:
                            found.append(self.finding(
                                module.rel, node.lineno,
                                f"module-scope import {alias.name}"))
                elif isinstance(node, ast.ImportFrom):
                    if node.level == 0 and (node.module or "").split(
                            ".")[0] in ROUTER_FORBIDDEN_ROOTS:
                        found.append(self.finding(
                            module.rel, node.lineno,
                            f"module-scope from {node.module} import"))
                elif isinstance(node, (ast.If, ast.Try, ast.With,
                                       ast.ClassDef)):
                    for attr in ("body", "orelse", "finalbody", "handlers"):
                        sub = getattr(node, attr, None)
                        if not sub:
                            continue
                        for item in sub:
                            if isinstance(item, ast.excepthandler):
                                walk(item.body)
                        walk([s for s in sub
                              if not isinstance(s, ast.excepthandler)])

        walk(module.tree.body)
        return found

    def finish(self, ctx: LintContext) -> List[Finding]:
        return _stale_entries(
            self, ctx, ROUTER_ROLE_MODULES, "ROUTER_ROLE_MODULES")


def _is_enabled_guard(node: ast.If) -> bool:
    t = node.test
    return (isinstance(t, ast.Attribute) and t.attr == "enabled"
            and isinstance(t.value, ast.Name) and t.value.id == "_CHAOS")


class ChaosGuardRule(Rule):
    """AST contract for the never-abort chaos layer:
    with chaos off, every compiled-in injection point is a single
    predictable branch — any ``_CHAOS`` use reachable without passing
    the ``enabled`` test is a hot-path regression."""

    id = "chaos-guard"
    severity = "error"
    description = ("every _CHAOS injection-point use sits under an "
                   "`if _CHAOS.enabled:` guard")

    def __init__(self) -> None:
        self._points: Dict[str, int] = {}

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        if module.rel not in CHAOS_INSTRUMENTED:
            return []
        found: List[Finding] = []
        points = [0]

        def walk(node, guarded):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "_CHAOS"
                    for t in node.targets):
                return  # the module-scope singleton capture
            if isinstance(node, ast.If) and _is_enabled_guard(node):
                points[0] += 1
                for child in node.body:
                    walk(child, True)
                for child in node.orelse:
                    walk(child, guarded)
                return
            if isinstance(node, ast.Name) and node.id == "_CHAOS" \
                    and not guarded:
                found.append(self.finding(
                    module.rel, node.lineno,
                    "_CHAOS use outside an `if _CHAOS.enabled:` guard"))
            for child in ast.iter_child_nodes(node):
                walk(child, guarded)

        walk(module.tree, False)
        self._points[module.rel] = points[0]
        floor = CHAOS_POINT_FLOORS[module.rel]
        if points[0] < floor:
            found.append(self.finding(
                module.rel, 0,
                f"module carries {points[0]} guarded injection "
                f"point(s), floor is {floor}"))
        return found

    def finish(self, ctx: LintContext) -> List[Finding]:
        found = _stale_entries(
            self, ctx, CHAOS_INSTRUMENTED, "CHAOS_INSTRUMENTED")
        total = sum(self._points.values())
        seen = [r for r in CHAOS_INSTRUMENTED if r in self._points]
        if len(seen) == len(CHAOS_INSTRUMENTED) and total < CHAOS_MIN_POINTS:
            found.append(self.finding(
                CHAOS_INSTRUMENTED[0], 0,
                f"chaos modules carry {total} guarded injection points, "
                f"expected >= {CHAOS_MIN_POINTS} (the walk must actually "
                "see the points)"))
        self._points = {}
        ctx.reports.setdefault("chaos_points", total)
        return found
