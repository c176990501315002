"""booked-launch: every kernel launch goes through ``ops.call_booked``.

The port's kernels are C entries of one library
(:func:`fmda_tpu_torch.ops._cuda_lib.load`), and each wrapper makes its
launching C call through :func:`fmda_tpu_torch.ops.call_booked`: that is
where the kernel ledger (:mod:`fmda_tpu_torch.obs.device`) books the
launch, its cost and its sampled device time, beside the launch counts
``launch_counts()`` reads.  A C call made around it launches a kernel the
ledger never sees — the device report's launches, FLOPs and MFU
undercount without any error.  This rule is the ratchet: inside ``ops/``
and ``parallel/``, a call of a C entry is a finding unless

- the entry is handed to ``call_booked`` (``call_booked(kernel, sig,
  fn, args)``), or
- the entry launches nothing and says so by its place in
  :data:`NO_LAUNCH_ENTRIES` (plan queries, the error string, the weight
  gradient's split count).

A C entry is an attribute named ``fmda_*`` of any object (``lib.fmda_X``)
or a ``getattr(lib, "fmda_...")`` with a literal or f-string name; a name
bound to one (``fn = getattr(lib, f"fmda_gru_scan_fwd_{tag}")``) is
followed through its function.  An f-string name is read as a pattern
over the entries the library exports (``extern "C"`` in ``csrc/``): it is
launch-free only when every exported entry it can name is in the list.
The list polices itself: an entry the library no longer exports, or that
no module calls any more, is a stale entry.

Pure AST and a regex over the C sources; stdlib only.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from typing import Dict, List, Optional, Set, Tuple

from fmda_tpu_torch.analysis.engine import (
    Finding, LintContext, ParsedModule, Rule)

#: package subtrees whose C calls are checked
SCOPE_PREFIXES = ("ops/", "parallel/")

#: the booking wrapper every launching C call goes through
BOOKING_WRAPPER = "call_booked"

#: C entries that launch no kernel: the flash plans
#: (``ops/attention_kernel.py``), the forward scans' plans
#: (``_cuda_lib.fwd_plan``), the persistent LSTM scans' plan
#: (``_cuda_lib.persist_plan_query``), the fused GRU steps' plans and the
#: backward's direction set-up (``ops/gru_wide_step.py``,
#: ``ops/gru_wide_bwd_step.py``), the weight gradient's split count
#: (``ops/scan_dw.py``) and the error string (``_cuda_lib.raise_on``)
NO_LAUNCH_ENTRIES = (
    "fmda_cuda_error_string",
    "fmda_flash_bwd_plan",
    "fmda_flash_fwd_plan",
    "fmda_gru_scan_fwd_plan",
    "fmda_gru_wide_bwd_scan_prepare_bf16",
    "fmda_gru_wide_bwd_step_plan",
    "fmda_gru_wide_scan_fwd_plan",
    "fmda_lstm_persist_plan",
    "fmda_lstm_scan_fwd_plan",
    "fmda_scan_dw_splits",
)

#: where the library's C sources live, relative to the package root
CSRC_DIR = "csrc"
CSRC_SUFFIXES = (".cu", ".cc", ".cuh", ".h")

ENTRY_PREFIX = "fmda_"
_EXPORT_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(fmda_\w+)\s*\(')


def exported_entries(ctx: LintContext) -> Optional[Set[str]]:
    """The C entries the library's sources export, or None when the
    package carries no ``csrc/`` (a fixture package)."""
    root = ctx.package_dir / CSRC_DIR
    if not root.is_dir():
        return None
    names: Set[str] = set()
    for path in sorted(root.iterdir()):
        if path.suffix in CSRC_SUFFIXES:
            names.update(_EXPORT_RE.findall(path.read_text()))
    return names


def _entry_pattern(node: ast.AST) -> Optional[str]:
    """The entry name (a glob pattern for an f-string) ``node`` names:
    ``X.fmda_y`` or ``getattr(X, "fmda_y" | f"fmda_{...}")``."""
    if isinstance(node, ast.Attribute):
        attr = node.attr
        return attr if attr.startswith(ENTRY_PREFIX) else None
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "getattr" and len(node.args) >= 2):
        return None
    name = node.args[1]
    if isinstance(name, ast.Constant) and isinstance(name.value, str):
        pattern = name.value
    elif isinstance(name, ast.JoinedStr):
        parts = []
        for v in name.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                parts.append("*")
        pattern = "".join(parts)
    else:
        return None
    return pattern if pattern.startswith(ENTRY_PREFIX) else None


def _parents(tree: ast.AST) -> Dict[ast.AST, ast.AST]:
    out: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            out[child] = node
    return out


def _is_booking_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = (fn.id if isinstance(fn, ast.Name)
            else fn.attr if isinstance(fn, ast.Attribute) else None)
    return name == BOOKING_WRAPPER


class BookedLaunchRule(Rule):
    id = "booked-launch"
    severity = "error"
    description = ("every kernel-launching C entry in ops/ and parallel/ "
                   "is called through ops.call_booked (launch-free entries "
                   "are listed by name)")

    def __init__(self) -> None:
        #: (rel, line, pattern, how) of every raw call seen this run
        self._raw: List[Tuple[str, int, str, str]] = []
        self._booked = 0

    def check(self, module: ParsedModule, ctx: LintContext) -> List[Finding]:
        if not module.rel.startswith(SCOPE_PREFIXES):
            return []
        parents = _parents(module.tree)
        #: (enclosing function, local name) -> entry pattern bound to it
        bound: Dict[Tuple[Optional[ast.AST], str], str] = {}

        def scope_of(node: ast.AST) -> Optional[ast.AST]:
            cur = parents.get(node)
            while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                cur = parents.get(cur)
            return cur

        for node in ast.walk(module.tree):
            pattern = _entry_pattern(node)
            if pattern is None:
                continue
            parent = parents.get(node)
            if isinstance(parent, ast.Call) and parent.func is node:
                self._raw.append(
                    (module.rel, node.lineno, pattern, "called directly"))
            elif _is_booking_call(parent):
                self._booked += 1
            elif (isinstance(parent, ast.Assign) and parent.value is node
                  and len(parent.targets) == 1
                  and isinstance(parent.targets[0], ast.Name)):
                bound[(scope_of(parent), parent.targets[0].id)] = pattern
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                pattern = bound.get((scope_of(node), node.func.id))
                if pattern is not None:
                    self._raw.append(
                        (module.rel, node.lineno, pattern,
                         f"called through `{node.func.id}`"))
            if _is_booking_call(node):
                for arg in [*node.args, *(k.value for k in node.keywords)]:
                    if isinstance(arg, ast.Name) and (
                            scope_of(node), arg.id) in bound:
                        self._booked += 1
        return []

    def _launch_free(self, pattern: str,
                     exported: Optional[Set[str]]) -> bool:
        if "*" not in pattern:
            return pattern in NO_LAUNCH_ENTRIES
        if exported is None:
            return False  # a pattern over an unknown library launches
        named = [e for e in exported if fnmatch.fnmatchcase(e, pattern)]
        return bool(named) and all(e in NO_LAUNCH_ENTRIES for e in named)

    def finish(self, ctx: LintContext) -> List[Finding]:
        exported = exported_entries(ctx)
        found: List[Finding] = []
        for rel, line, pattern, how in self._raw:
            if self._launch_free(pattern, exported):
                continue
            found.append(self.finding(
                rel, line,
                f"C entry {pattern} {how}, outside ops.call_booked — the "
                "kernel ledger and launch_counts() never see the launch; "
                "pass it to call_booked, or list an entry that launches "
                "nothing in NO_LAUNCH_ENTRIES"))
        for name in NO_LAUNCH_ENTRIES:
            if exported is not None and name not in exported:
                found.append(self.finding(
                    CSRC_DIR, 0,
                    f"stale NO_LAUNCH_ENTRIES entry: {name} is not "
                    "exported by the library's C sources"))
            elif not any(fnmatch.fnmatchcase(name, p)
                         for _, _, p, _ in self._raw):
                found.append(self.finding(
                    SCOPE_PREFIXES[0], 0,
                    f"stale NO_LAUNCH_ENTRIES entry: {name} is called "
                    "nowhere in " + " or ".join(SCOPE_PREFIXES)))
        ctx.reports["booked_launch"] = {
            "exported": None if exported is None else sorted(exported),
            "booked_sites": self._booked,
        }
        self._raw = []
        self._booked = 0
        return found
