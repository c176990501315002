"""virtual-clock: replay pacing and ordering never read the host clock.

The replay subsystem's whole contract is that a
backfill is **deterministic**: the virtual clock is the rows' own
timestamps, so the same history replayed twice — or replayed on a
loaded host vs a quiet one — produces the same rounds in the same
order with the same virtual watermarks.  One ``time.time()`` threaded
into round sequencing quietly turns that into "usually the same", and
the bit-identity gate only catches it when the race actually fires.

This rule is the static half of the guarantee: inside
``fmda_tpu_torch/replay/`` any call into the wall-clock/sleep surface —
``time.time``/``monotonic``/``perf_counter`` (and ``_ns``
variants)/``sleep``, and
``datetime.now``/``utcnow``/``today`` — is a finding unless the site
carries the standard in-place hatch (``# lint: ignore[virtual-clock]
reason``) naming why it is telemetry, not pacing: the driver's rows/s
gauges read ``perf_counter`` and its backpressure loop yields the GIL,
and the cadence-paced live *reference* loop paces on the host clock on
purpose (that baseline is the thing replay is measured against).
Alias-aware: ``import time as t`` and ``from time import sleep as s``
are still caught.

Pure AST, no imports beyond the engine.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

#: the package prefix that IS the replay subsystem
SCOPE_PREFIX = "replay/"

#: wall-clock / pacing calls on the time module
TIME_FUNCS = ("time", "monotonic", "monotonic_ns", "perf_counter",
              "perf_counter_ns", "sleep")

#: wall-clock constructors on the datetime class
DATETIME_FUNCS = ("now", "utcnow", "today")


class VirtualClockRule(Rule):
    id = "virtual-clock"
    severity = "error"
    description = ("replay/ modules pace and order on the virtual clock "
                   "only — wall-clock reads need an annotated reason")

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        rel = module.rel
        if not rel.startswith(SCOPE_PREFIX):
            return []
        time_aliases: Set[str] = set()
        dt_cls_aliases: Set[str] = set()
        func_aliases: Dict[str, str] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        time_aliases.add(a.asname or "time")
                    elif a.name == "datetime":
                        # `import datetime` -> datetime.datetime.now(...)
                        # is caught by the attr check on the class alias
                        dt_cls_aliases.add(a.asname or "datetime")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time":
                    for a in node.names:
                        if a.name in TIME_FUNCS:
                            func_aliases[a.asname or a.name] = a.name
                elif node.module == "datetime":
                    for a in node.names:
                        if a.name == "datetime":
                            dt_cls_aliases.add(a.asname or "datetime")
        found: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            call = None
            if isinstance(fn, ast.Attribute):
                base = fn.value
                if (fn.attr in TIME_FUNCS and isinstance(base, ast.Name)
                        and base.id in time_aliases):
                    call = f"time.{fn.attr}"
                elif fn.attr in DATETIME_FUNCS:
                    if (isinstance(base, ast.Name)
                            and base.id in dt_cls_aliases):
                        call = f"datetime.{fn.attr}"
                    elif (isinstance(base, ast.Attribute)
                          and base.attr == "datetime"
                          and isinstance(base.value, ast.Name)
                          and base.value.id in dt_cls_aliases):
                        call = f"datetime.datetime.{fn.attr}"
            elif isinstance(fn, ast.Name) and fn.id in func_aliases:
                call = f"time.{func_aliases[fn.id]}"
            if call is not None:
                found.append(self.finding(
                    rel, node.lineno,
                    f"wall-clock {call}() in the replay subsystem — "
                    f"pace and order on the rows' virtual clock, or "
                    f"annotate a telemetry-only site with "
                    f"`# lint: ignore[{self.id}] reason`"))
        return found

    def finish(self, ctx: LintContext) -> List[Finding]:
        # the scope polices its own staleness: if the replay package
        # moves, this rule must move with it, not silently go vacuous
        if not any(m.rel.startswith(SCOPE_PREFIX) for m in ctx.modules):
            return [self.finding(
                SCOPE_PREFIX, 0,
                f"stale scope: no modules under {SCOPE_PREFIX} — the "
                f"replay package moved without updating this rule")]
        return []
