"""wire-protocol: the fleet dialect cross-checked statically.

The fleet speaks two layered vocabularies: transport **ops** (the
``"op"`` field of BusServer frames — ``publish``/``read``/``batch``/
``hello``...) and control/data **message kinds** (the ``"kind"`` field
of inbox and control-topic messages — ``tick``/``open``/
``drain_session``/``session_state``...).  Both are stringly typed: a
producer emitting an op no server branch handles fails at runtime with
an unknown-op error, and a consumer branch for a kind nothing produces
is dead protocol surface that rots silently.  Since wire v2
there is also a **dialect split**: v2 constructs —
columnar tick/result blocks, raw-array state — must always have a
reachable ``to_legacy`` lowering so a mixed-version fleet keeps
parsing.  This rule proves all three properties per lint run:

- **produced ⊆ consumed** — every op/kind built in a protocol module
  (dict literals, constants resolved through the program index, and
  one-level parameter flow: ``self._publish(HELLO, ...)`` into a helper
  that stamps ``{"kind": kind}``) must have a consumer branch (an
  ``op == "..."`` / ``kind in (...)`` comparison) somewhere;
- **consumed ⊆ produced** — a branch comparing against an op/kind no
  code produces is flagged (operator-facing entry points such as the
  worker's ``leave`` message annotate themselves in place:
  ``# lint: ignore[wire-protocol] reason``);
- **v2 lowering** — a module producing columnar tick blocks
  (``coalesce_ticks``/``pack_ticks``) must reference a legacy lowering
  (``to_legacy_msgs``/``legacy_tick``); ``pack_results`` must sit under
  a conditional (the per-tick dialect must stay reachable); and
  ``msg.get("wire", default)`` must default to **pre-v2** — a default
  of 2+ would treat every old peer as v2 and feed it frames it cannot
  parse.

Scope lists are explicit (and police their own staleness, like
``hot-path-json``): the op layer lives in ``fleet/wire.py`` + the
router/worker that build batched ops; the kind layer in the fleet
control/data modules + the codec (``fleet/wire.py`` is deliberately
NOT in it — its ``{"err", "kind"}`` error frames carry exception class
names, a different vocabulary).  Pure AST + the program index;
stdlib only.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

#: modules that build/dispatch transport ops (``"op"`` dicts)
OP_MODULES = ("fleet/wire.py", "fleet/router.py", "fleet/worker.py")

#: modules that build/branch on message kinds (``"kind"`` dicts)
KIND_MODULES = (
    "fleet/router.py",
    "fleet/worker.py",
    "fleet/membership.py",
    "fleet/state.py",
    "stream/codec.py",
)

#: modules under the v2-dialect checks (block producers + wire readers)
V2_MODULES = (
    "fleet/router.py",
    "fleet/worker.py",
    "fleet/membership.py",
    "fleet/state.py",
    "runtime/gateway.py",
)

#: the codec defines the block constructors — calls inside it are the
#: implementation, not a dialect decision
CODEC_MODULE = "stream/codec.py"

#: v2 block producers -> the legacy-lowering spellings whose presence
#: proves the module can speak pre-v2
TICK_BLOCK_PRODUCERS = ("coalesce_ticks", "pack_ticks")
LEGACY_LOWERINGS = ("to_legacy_msgs", "legacy_tick", "to_legacy")


def _dict_key_value(node: ast.Dict, key: str) -> Optional[ast.AST]:
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and k.value == key:
            return v
    return None


def _get_call_key(node: ast.AST) -> Optional[str]:
    """``"kind"`` for an ``X.get("kind", ...)`` call node."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and node.args
            and isinstance(node.args[0], ast.Constant)):
        v = node.args[0].value
        return v if isinstance(v, str) else None
    return None


class _Vocab:
    """One layer's harvest: who produces / consumes which literal."""

    def __init__(self) -> None:
        #: value -> [(rel, line)]
        self.produced: Dict[str, List[Tuple[str, int]]] = {}
        self.consumed: Dict[str, List[Tuple[str, int]]] = {}

    def produce(self, value: str, rel: str, line: int) -> None:
        self.produced.setdefault(value, []).append((rel, line))

    def consume(self, value: str, rel: str, line: int) -> None:
        self.consumed.setdefault(value, []).append((rel, line))


class WireProtocolRule(Rule):
    id = "wire-protocol"
    severity = "error"
    description = ("every produced wire op/kind has a consumer branch and "
                   "vice versa; v2 constructs keep a reachable legacy "
                   "lowering")

    def __init__(self) -> None:
        self._ops = _Vocab()
        self._kinds = _Vocab()
        self._v2: List[Finding] = []

    # -- per-module harvest --------------------------------------------------

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        rel = module.rel
        index = ctx.index()
        if rel in OP_MODULES:
            self._harvest_layer(module, index, "op", self._ops)
        if rel in KIND_MODULES:
            self._harvest_layer(module, index, "kind", self._kinds)
        if rel in V2_MODULES:
            self._check_v2(module)
        return []

    def _harvest_layer(self, module: ParsedModule, index, key: str,
                       vocab: _Vocab) -> None:
        rel = module.rel
        #: one-level parameter flow: functions whose body stamps
        #: ``{key: <param>}`` — a call passing a resolvable constant at
        #: that position (or by keyword) produces it
        param_stampers: Dict[str, Tuple[int, str]] = {}
        for name, infos in index.functions.get(rel, {}).items():
            for info in infos:
                stamp = self._stamp_param(info, key)
                if stamp is not None:
                    param_stampers[name] = stamp
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Dict):
                value = _dict_key_value(node, key)
                if value is None:
                    continue
                for v in self._produced_values(module, index, node, value):
                    vocab.produce(v, rel, node.lineno)
            elif isinstance(node, ast.Compare):
                self._harvest_compare(module, index, key, vocab, node)
            elif isinstance(node, ast.Call):
                fname = None
                if isinstance(node.func, ast.Name):
                    fname = node.func.id
                elif isinstance(node.func, ast.Attribute):
                    fname = node.func.attr
                stamp = param_stampers.get(fname)
                if stamp is not None:
                    pos, pname = stamp
                    arg = None
                    if pos < len(node.args):
                        arg = node.args[pos]
                    else:
                        for kw in node.keywords:
                            if kw.arg == pname:
                                arg = kw.value
                                break
                    v = (index.resolve_constant(arg)
                         if arg is not None else None)
                    if v is not None:
                        vocab.produce(v, rel, node.lineno)

    @staticmethod
    def _stamp_param(info, key: str) -> Optional[Tuple[int, str]]:
        """``(call-site arg position, param name)`` of the parameter
        whose value flows into a ``{key: <param>}`` dict in ``info``'s
        body (``self`` stripped from the position; the name resolves
        keyword-argument call sites)."""
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Dict):
                continue
            value = _dict_key_value(node, key)
            if isinstance(value, ast.Name) and value.id in info.params:
                pos = info.params.index(value.id)
                if info.params and info.params[0] == "self":
                    pos -= 1
                return (pos, value.id) if pos >= 0 else None
        return None

    def _produced_values(self, module: ParsedModule, index,
                         dict_node: ast.Dict, value: ast.AST) -> List[str]:
        """Literal values a ``{key: <value>}`` production can take:
        constants, module constants, local single-assignment names
        (incl. the ``"a" if c else "b"`` shape)."""
        direct = index.resolve_constant(value)
        if direct is not None:
            return [direct]
        if isinstance(value, ast.IfExp):
            out = []
            for branch in (value.body, value.orelse):
                v = index.resolve_constant(branch)
                if v is not None:
                    out.append(v)
            return out
        if isinstance(value, ast.Name):
            # local constant: `kind = "drain_all" if graceful else "stop"`
            return self._local_values(module, value.id, dict_node)
        return []

    @staticmethod
    def _local_values(module: ParsedModule, name: str,
                      before: ast.AST) -> List[str]:
        out: Set[str] = set()
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == name
                    and node.lineno <= before.lineno):
                continue
            v = node.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                out.add(v.value)
            elif isinstance(v, ast.IfExp):
                for branch in (v.body, v.orelse):
                    if isinstance(branch, ast.Constant) and isinstance(
                            branch.value, str):
                        out.add(branch.value)
        return sorted(out)

    def _harvest_compare(self, module: ParsedModule, index, key: str,
                         vocab: _Vocab, node: ast.Compare) -> None:
        """``kind == "open"`` / ``kind in (HELLO, ...)`` /
        ``v.get("kind") == "result_block"`` -> consumer branches."""
        sides = [node.left, *node.comparators]
        keyed = any(
            (isinstance(s, ast.Name) and s.id == key)
            or _get_call_key(s) == key
            for s in sides
        )
        if not keyed:
            return
        for s in sides:
            if isinstance(s, (ast.Tuple, ast.List, ast.Set)):
                for e in s.elts:
                    v = index.resolve_constant(e)
                    if v is not None:
                        vocab.consume(v, module.rel, node.lineno)
            else:
                v = index.resolve_constant(s)
                if v is not None:
                    vocab.consume(v, module.rel, node.lineno)

    # -- the v2 dialect checks -----------------------------------------------

    def _check_v2(self, module: ParsedModule) -> None:
        rel = module.rel
        refs = {
            n.id for n in ast.walk(module.tree) if isinstance(n, ast.Name)
        } | {
            n.attr for n in ast.walk(module.tree)
            if isinstance(n, ast.Attribute)
        }
        has_lowering = any(name in refs for name in LEGACY_LOWERINGS)
        guarded = self._branch_guarded_calls(module.tree)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Call):
                fname = (node.func.attr
                         if isinstance(node.func, ast.Attribute)
                         else node.func.id
                         if isinstance(node.func, ast.Name) else None)
                if fname in TICK_BLOCK_PRODUCERS and not has_lowering:
                    self._v2.append(self.finding(
                        rel, node.lineno,
                        f"produces columnar tick blocks ({fname}) with no "
                        "reachable legacy lowering — a pre-v2 peer on "
                        "this path cannot parse (fmda_tpu_torch.fleet.state"
                        ".to_legacy_msgs)"))
                elif fname == "pack_results" and node not in guarded:
                    self._v2.append(self.finding(
                        rel, node.lineno,
                        "unconditional pack_results — the per-tick result "
                        "dialect must stay reachable for pre-v2 "
                        "consumers (gate the block path on negotiated "
                        "capability)"))
                wire_default = self._wire_get_default(node)
                if wire_default is not None and wire_default >= 2:
                    self._v2.append(self.finding(
                        rel, node.lineno,
                        f'`.get("wire", {wire_default})` treats peers '
                        "that never declared a dialect as v2 — the "
                        "absent-field default must stay pre-v2"))

    @staticmethod
    def _branch_guarded_calls(tree: ast.AST) -> Set[ast.AST]:
        """Call nodes that sit under an ``if``/``try`` somewhere inside
        their enclosing function — i.e. a fallback path can exist."""
        guarded: Set[ast.AST] = set()

        def walk(node: ast.AST, under: bool) -> None:
            for child in ast.iter_child_nodes(node):
                child_under = under
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    child_under = False
                elif isinstance(child, (ast.If, ast.IfExp, ast.Try)):
                    child_under = True
                if child_under and isinstance(child, ast.Call):
                    guarded.add(child)
                walk(child, child_under)

        walk(tree, False)
        return guarded

    @staticmethod
    def _wire_get_default(node: ast.Call) -> Optional[int]:
        if (_get_call_key(node) == "wire" and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, int)):
            return int(node.args[1].value)
        return None

    # -- whole-program verdicts ----------------------------------------------

    def finish(self, ctx: LintContext) -> List[Finding]:
        found: List[Finding] = list(self._v2)
        for layer, vocab in (("op", self._ops), ("kind", self._kinds)):
            for value, sites in sorted(vocab.produced.items()):
                if value in vocab.consumed:
                    continue
                rel, line = sites[0]
                found.append(self.finding(
                    rel, line,
                    f"{layer} {value!r} is produced but no consumer "
                    "branch handles it — dead protocol surface or a "
                    "typo'd literal"))
            for value, sites in sorted(vocab.consumed.items()):
                if value in vocab.produced:
                    continue
                rel, line = sites[0]
                found.append(self.finding(
                    rel, line,
                    f"{layer} {value!r} has a consumer branch but is "
                    "never produced anywhere — dead branch or a typo'd "
                    "literal"))
        ctx.reports["wire_protocol"] = {
            "ops": {
                "produced": sorted(self._ops.produced),
                "consumed": sorted(self._ops.consumed),
            },
            "kinds": {
                "produced": sorted(self._kinds.produced),
                "consumed": sorted(self._kinds.consumed),
            },
        }
        # scope lists police their own staleness
        for rel in dict.fromkeys(OP_MODULES + KIND_MODULES + V2_MODULES):
            if ctx.module(rel) is None \
                    and not (ctx.package_dir / rel).is_file():
                found.append(self.finding(
                    rel, 0, f"stale scope entry: {rel} does not exist"))
        self._ops = _Vocab()
        self._kinds = _Vocab()
        self._v2 = []
        return found
