"""hot-path-json: the data plane's json encode/decode stays in the codec.

The data plane's JSON boundaries — wire frames, bus values, the
migration state codec, the journal — go through the binary codec
(:mod:`fmda_tpu_torch.stream.codec`).  That win erodes one convenient
``json.dumps`` at a time: a counter serialized per tick here, a debug
field re-encoded per flush there, and the serialize/parse tax is back
without any single diff looking hot.  This rule is the ratchet: inside
the data-plane scope — ``fleet/``, ``runtime/``, and the bus/journal
transport modules under ``stream/`` — any ``json.dumps``/``loads``/
``dump``/``load`` call is a finding unless it sits in the codec module
itself or carries the standard in-place hatch
(``# lint: ignore[hot-path-json] reason``) naming why the site is
control-plane (the journal's human-inspectable JSONL layout, for
example).  Alias-aware: ``import json as j`` and ``from json import
dumps as d`` are still caught.

Pure AST, no imports beyond the engine.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

#: directory prefixes inside the package that ARE the data plane
SCOPE_PREFIXES = ("fleet/", "runtime/")

#: stream-layer transport modules on the same hot path
SCOPE_MODULES = (
    "stream/bus.py",
    "stream/native_bus.py",
    "stream/kafka_bus.py",
    "stream/journal.py",
)

#: the one sanctioned home for json on the data plane
CODEC_MODULES = ("stream/codec.py",)

JSON_FUNCS = ("dumps", "loads", "dump", "load")


class HotPathJsonRule(Rule):
    id = "hot-path-json"
    severity = "error"
    description = ("data-plane modules call json.dumps/loads only inside "
                   "the codec module or at annotated control-plane sites")

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        rel = module.rel
        in_scope = (rel.startswith(SCOPE_PREFIXES)
                    or rel in SCOPE_MODULES)
        if not in_scope or rel in CODEC_MODULES:
            return []
        mod_aliases: Set[str] = set()
        func_aliases: Dict[str, str] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "json":
                        mod_aliases.add(a.asname or "json")
            elif isinstance(node, ast.ImportFrom) and node.module == "json":
                for a in node.names:
                    if a.name in JSON_FUNCS:
                        func_aliases[a.asname or a.name] = a.name
        if not mod_aliases and not func_aliases:
            return []
        found: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            call = None
            if (isinstance(fn, ast.Attribute) and fn.attr in JSON_FUNCS
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in mod_aliases):
                call = f"json.{fn.attr}"
            elif isinstance(fn, ast.Name) and fn.id in func_aliases:
                call = f"json.{func_aliases[fn.id]}"
            if call is not None:
                found.append(self.finding(
                    rel, node.lineno,
                    f"data-plane {call}() — encode through "
                    f"fmda_tpu_torch.stream.codec, or annotate a deliberate "
                    f"control-plane site with "
                    f"`# lint: ignore[{self.id}] reason`"))
        return found

    def finish(self, ctx: LintContext) -> List[Finding]:
        # the scope lists police their own staleness, like every other
        # module-list rule: a refactor that moves a listed file must
        # shrink the list, not silently stop checking
        found: List[Finding] = []
        for rel in SCOPE_MODULES + CODEC_MODULES:
            if not (ctx.package_dir / rel).is_file():
                found.append(self.finding(
                    rel, 0,
                    f"stale scope entry: {rel} does not exist",
                    severity="error"))
        return found
