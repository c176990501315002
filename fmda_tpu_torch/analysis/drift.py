"""Torch API-drift scanner.

The port runs against whatever PyTorch the host carries: a CPU build
where the tests run, a CUDA build beside the card, and each a version
of its own.  A symbol that one of them renamed or dropped fails only
when the line that uses it runs — a rarely taken branch can carry it for
weeks.  This rule resolves every dotted reference into ``torch.*``
across the whole package (the port's torch surface reaches well past
``ops/``, ``models/`` and ``parallel/``: the trainer, the serving
runtime, the device plane) against the **installed** torch and reports
the ones that no longer exist, as findings plus a machine-readable
inventory (``ctx.reports["torch_api_drift"]``, written by
``lint --drift-report FILE``):

    {"torch_version": "...", "n_symbols": N, "n_sites": M,
     "symbols": {"torch.nn.functional.X": [{"path","line"}, ...]}}

How references are gathered: import aliases are tracked per module
(``import torch.nn.functional as F`` → ``F.X`` is
``torch.nn.functional.X``; ``from torch import nn`` → ``nn.Y``; direct
symbol imports are checked at the import line), then every maximal
attribute chain rooted at an alias is resolved by importing the longest
module prefix and ``getattr``-ing the rest.  Only static module-path
references are judged — values passed around as objects are invisible,
so this is a lower bound on drift, never a false alarm on style.

Resolution is attribute lookup only: nothing is called, so a
``torch.cuda.X`` reference never initialises CUDA, and lint touches no
device.  torch is imported in a resolver process of its own, started
before the other rules run (:meth:`TorchApiDriftRule.start`): the import
takes seconds on a CUDA build, and the lint process itself never loads
torch.

This rule is a **zero-baseline hard gate** (``grandfatherable =
False``): an unresolved symbol fails lint the commit it appears in, with
no grandfathering — a baseline entry carrying this rule's id is itself a
gate failure (``LintResult.forbidden_baseline``) and the inline hatch is
inert.  The inventory is not committed: it is a property of the host's
torch, so the tree test and the card's smoke read it live.
"""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

#: reference roots that are resolved (module path prefixes)
_TORCH_ROOT = "torch"


def _aliases(tree: ast.AST) -> Tuple[Dict[str, str], List[Tuple[int, str]]]:
    """Module-path aliases + directly imported symbols, whole module
    (function-scope imports included — deferred imports are the port's
    sanctioned pattern for torch in lazily-loaded modules): ``{local
    name: dotted module path}`` and ``[(line, dotted symbol)]`` for
    ``from torch.x import y`` imports."""
    aliases: Dict[str, str] = {}
    symbols: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] != _TORCH_ROOT:
                    continue
                if alias.asname:
                    aliases[alias.asname] = alias.name
                else:
                    # `import torch.nn` binds `torch`; chains through the
                    # bare root are resolved from `torch` itself
                    aliases.setdefault(_TORCH_ROOT, _TORCH_ROOT)
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level or mod.split(".")[0] != _TORCH_ROOT:
                continue
            for alias in node.names:
                if alias.name == "*":
                    continue
                dotted = f"{mod}.{alias.name}"
                symbols.append((node.lineno, dotted))
                # the imported name may itself be a module used as a
                # root (`from torch import nn`)
                aliases[alias.asname or alias.name] = dotted
    return aliases, symbols


def _refs(tree: ast.AST, aliases: Dict[str, str]) -> List[Tuple[int, str]]:
    """Maximal attribute chains rooted at a torch alias: ``(line,
    dotted)`` for every ``alias.a.b`` that is not itself the inside of a
    longer chain (each chain is taken whole, once; a chain rooted in a
    call or a subscript is not followed, the chains inside its root are
    walked on their own)."""
    inner = set()
    refs: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute) or node in inner:
            continue
        chain: List[str] = []
        cur: ast.AST = node
        while isinstance(cur, ast.Attribute):
            chain.append(cur.attr)
            inner.add(cur)
            cur = cur.value
        if isinstance(cur, ast.Name) and cur.id in aliases:
            refs.append(
                (node.lineno, ".".join([aliases[cur.id], *reversed(chain)])))
    return refs


class TorchApiDriftRule(Rule):
    id = "torch-api-drift"
    severity = "error"
    description = ("every torch.* reference in the package must resolve "
                   "against the installed torch")
    grandfatherable = False  # zero-baseline: drift is fixed, never filed

    def __init__(self) -> None:
        #: the resolver process, from :meth:`start` until :meth:`finish`
        self._resolver: Optional[subprocess.Popen] = None
        #: (rel, line, dotted) of every torch reference seen this run
        self._refs: List[Tuple[str, int, str]] = []
        self._n_modules = 0

    def start(self) -> None:
        """Spawn the resolver process: its ``import torch`` (seconds on a
        CUDA build) runs while the other rules walk the tree."""
        if self._resolver is None:
            self._resolver = subprocess.Popen(
                [sys.executable, "-c", _RESOLVER.format(
                    root=str(pathlib.Path(__file__).resolve().parents[2]))],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        if _TORCH_ROOT not in module.text:
            return []
        aliases, symbols = _aliases(module.tree)
        if not aliases and not symbols:
            return []
        self._n_modules += 1
        self._refs.extend(
            (module.rel, line, dotted)
            for line, dotted in sorted(set(symbols)
                                       | set(_refs(module.tree, aliases))))
        return []

    def finish(self, ctx: LintContext) -> List[Finding]:
        self.start()
        resolver, self._resolver = self._resolver, None
        names = sorted({dotted for _, _, dotted in self._refs})
        try:
            out, err = resolver.communicate(json.dumps(names),
                                            timeout=RESOLVE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            resolver.kill()
            resolver.communicate()
            raise RuntimeError(
                f"torch-api-drift: the resolver took over "
                f"{RESOLVE_TIMEOUT_S} s") from None
        if resolver.returncode != 0:
            raise RuntimeError(
                f"torch-api-drift: the resolver failed "
                f"({resolver.returncode}): {err[-2000:]}")
        answer = json.loads(out)
        resolves = answer["resolves"]
        found: List[Finding] = []
        sites: Dict[str, List[Dict[str, object]]] = {}
        reported = set()
        for rel, line, dotted in self._refs:
            if resolves[dotted]:
                continue
            sites.setdefault(dotted, []).append({"path": rel, "line": line})
            if (rel, dotted) in reported:
                continue  # one finding per symbol per module
            reported.add((rel, dotted))
            found.append(self.finding(
                rel, line, f"unresolved torch reference: {dotted}"))
        ctx.reports["torch_api_drift"] = {
            "torch_version": answer["torch_version"],
            "n_modules": self._n_modules,
            "n_sites": len(self._refs),
            "n_symbols": len(sites),
            "symbols": {k: sites[k] for k in sorted(sites)},
        }
        self._refs = []
        self._n_modules = 0
        return found


#: the resolver process's program: ``root`` is the directory holding the
#: package
_RESOLVER = (
    "import sys\n"
    "sys.path.insert(0, {root!r})\n"
    "from fmda_tpu_torch.analysis.drift import serve_resolution\n"
    "serve_resolution()\n")

#: the longest the resolver may take, its torch import included
RESOLVE_TIMEOUT_S = 300.0


def serve_resolution() -> None:
    """The resolver process's body: import torch at once, then answer the
    JSON list of dotted names on stdin with ``{"torch_version",
    "resolves": {dotted: bool}}`` on stdout.  A host without torch
    answers every name unresolved; the lint command steers such hosts to
    ``--no-drift`` before it gets here."""
    try:
        import torch

        version = str(torch.__version__)
    except Exception:  # noqa: BLE001 — see docstring
        version = None
    names = json.loads(sys.stdin.read() or "[]")
    json.dump({"torch_version": version,
               "resolves": {n: version is not None
                            and _resolve_against_installed(n)
                            for n in names}}, sys.stdout)


def _resolve_against_installed(dotted: str) -> bool:
    """Import the longest module prefix, then getattr the rest.  Any
    import-time explosion (renamed module, version-gated init) counts
    as unresolved — the symbol is unusable either way."""
    import importlib

    parts = dotted.split(".")
    obj = None
    depth = 0
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
            depth = i
            break
        except Exception:  # noqa: BLE001 — see docstring
            continue
    if obj is None:
        return False
    for attr in parts[depth:]:
        try:
            obj = getattr(obj, attr)
        except AttributeError:
            return False
    return True
