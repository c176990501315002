"""Framework-aware static analysis for the ``fmda_tpu_torch`` tree.

One pluggable AST-analyzer engine (:mod:`fmda_tpu_torch.analysis.engine`)
and the rule catalog that runs on it:

========================  ==========  =========================================
rule id                   severity    contract
========================  ==========  =========================================
``logging-hygiene``       error       no print()/foreign loggers in library
                                      code (the command line,
                                      ``__main__.py`` and ``obs/report.py``,
                                      prints by contract)
``span-wall-clock``       error       span code never reads the wall clock
``router-torch-import``   error       router-role fleet modules import no
                                      torch and no jax at module scope
``chaos-guard``           error       every ``_CHAOS`` touch sits under
                                      ``if _CHAOS.enabled:``
``lock-discipline``       warning     lock-guarded attributes accessed inside
                                      ``with self._lock:`` only
``bus-topics``            error       published topic literals are declared
                                      or consumed somewhere
``metric-names``          error       registered series names are
                                      exposition-safe, unprefixed,
                                      kind-unique, label-key consistent
``hot-path-json``         error       data-plane modules (fleet/, runtime/,
                                      stream transport) call json only in
                                      the codec module or at annotated
                                      control-plane sites
``counted-loss``          warning     hot-path except handlers re-raise,
                                      count, or carry ``# loss-free:
                                      reason``; loss counters cross-check
                                      against the soak gates' vocabulary
``wire-protocol``         error       every produced op/kind has a consumer
                                      branch and vice versa; v2 constructs
                                      keep a reachable legacy lowering
``thread-lifecycle``      error       spawned threads are daemonized or
                                      joined/cancelled on a close path
``virtual-clock``         error       replay/ modules pace and order on the
                                      virtual clock only; wall-clock reads
                                      are annotated telemetry sites
``booked-launch``         error       in ops/ and parallel/, every C entry
                                      that launches a kernel is called
                                      through ``ops.call_booked``, so the
                                      kernel ledger and ``launch_counts()``
                                      see every launch
``torch-api-drift``       error       every torch.* reference in the package
                                      resolves against the installed torch
                                      (zero-baseline hard gate)
========================  ==========  =========================================

The reference package's (``fmda_tpu.analysis``) sixteen rules map onto
these fourteen.  Eleven carry over with their ids and contracts.
``router-jax-import`` becomes ``router-torch-import``, ``jax-api-drift``
becomes ``torch-api-drift`` and ``tracked-jit`` (serving programs compile
through the compile ledger) becomes ``booked-launch`` (kernels launch
through the launch ledger).  Two have no counterpart:

- ``jit-purity`` guards functions that a tracer captures (jit, pjit,
  shard_map) against host side effects and use of donated buffers.  The
  port traces and captures nothing — no ``torch.compile``, no
  ``torch.jit``, no CUDA graph — so such a rule would guard nothing; a
  capture-purity rule comes with CUDA graphs.
- ``compat-required`` confines the jax spellings of the reference's
  version shim (``fmda_tpu/compat.py``'s ``SHIMMED_SYMBOLS``) to that
  shim.  The port has no shim, and ``torch-api-drift`` holds its torch
  surface to the installed torch.

Entry points: ``python -m fmda_tpu_torch lint`` (exit 0 = clean vs
baseline, 1 = new findings, 2 = usage error) and :func:`run_lint` for
tests.  Lint reads source files on the host: it takes no device and
never initialises CUDA.
"""

from fmda_tpu_torch.analysis.accounting import CountedLossRule
from fmda_tpu_torch.analysis.booked_launch import (
    NO_LAUNCH_ENTRIES, BookedLaunchRule)
from fmda_tpu_torch.analysis.drift import TorchApiDriftRule
from fmda_tpu_torch.analysis.engine import (
    DEFAULT_BASELINE,
    Finding,
    LintContext,
    LintResult,
    ParsedModule,
    Rule,
    apply_baseline,
    collect_modules,
    load_baseline,
    run_lint,
    run_rules,
    save_baseline,
)
from fmda_tpu_torch.analysis.hot_json import HotPathJsonRule
from fmda_tpu_torch.analysis.hygiene import (
    ChaosGuardRule,
    LoggingHygieneRule,
    RouterTorchImportRule,
    SpanClockRule,
)
from fmda_tpu_torch.analysis.locks import LockDisciplineRule
from fmda_tpu_torch.analysis.metric_names import MetricNamesRule
from fmda_tpu_torch.analysis.program import ProgramIndex
from fmda_tpu_torch.analysis.protocol import WireProtocolRule
from fmda_tpu_torch.analysis.sarif import to_sarif
from fmda_tpu_torch.analysis.threads import ThreadLifecycleRule
from fmda_tpu_torch.analysis.topics import BusTopicRule
from fmda_tpu_torch.analysis.virtual_clock import VirtualClockRule

__all__ = [
    "DEFAULT_BASELINE",
    "NO_LAUNCH_ENTRIES",
    "Finding",
    "LintContext",
    "LintResult",
    "ParsedModule",
    "Rule",
    "apply_baseline",
    "collect_modules",
    "load_baseline",
    "run_lint",
    "run_rules",
    "save_baseline",
    "default_rules",
    "rule_catalog",
    "BookedLaunchRule",
    "BusTopicRule",
    "ChaosGuardRule",
    "CountedLossRule",
    "HotPathJsonRule",
    "LockDisciplineRule",
    "LoggingHygieneRule",
    "MetricNamesRule",
    "ProgramIndex",
    "RouterTorchImportRule",
    "SpanClockRule",
    "ThreadLifecycleRule",
    "TorchApiDriftRule",
    "VirtualClockRule",
    "WireProtocolRule",
    "to_sarif",
]


def default_rules(*, drift: bool = True):
    """Fresh instances of the full catalog (rules carry per-run state).
    ``drift=False`` skips the torch resolver — the only rule that imports
    torch — for torch-free hosts and fast editor loops."""
    rules = [
        LoggingHygieneRule(),
        SpanClockRule(),
        RouterTorchImportRule(),
        ChaosGuardRule(),
        LockDisciplineRule(),
        BusTopicRule(),
        MetricNamesRule(),
        HotPathJsonRule(),
        CountedLossRule(),
        WireProtocolRule(),
        ThreadLifecycleRule(),
        VirtualClockRule(),
        BookedLaunchRule(),
    ]
    if drift:
        rules.append(TorchApiDriftRule())
    return rules


def rule_catalog(*, drift: bool = True):
    """``{rule_id: description}`` for ``lint --rule`` validation/help."""
    return {r.id: r.description for r in default_rules(drift=drift)}
