"""fmda_tpu_torch.analysis: the port's lint gate held to the reference's.

Each of the eleven framework-neutral rules runs the fixture sources of
``tests/test_analysis.py`` (and ``tests/test_replay.py`` for the
virtual clock) through ``fmda_tpu.analysis``'s rule and the port's, on
the same fixture modules in a tmp package: both report the same
``(rule, path, line)``, with messages equal up to the package name.  The
three counterparts (``router-torch-import``, ``torch-api-drift``,
``booked-launch``) each get a failing and a clean case; then the CLI's
contract, and one run of the whole catalog over the port's own tree.
"""

import json
import pathlib
import re
import subprocess
import sys

import pytest

import fmda_tpu.analysis as ref
import fmda_tpu_torch
import fmda_tpu_torch.analysis as port
from fmda_tpu.analysis import accounting as ref_accounting
from fmda_tpu.analysis import hot_json as ref_hot_json
from fmda_tpu.analysis import hygiene as ref_hygiene
from fmda_tpu.analysis import protocol as ref_protocol
from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.analysis import accounting as port_accounting
from fmda_tpu_torch.analysis import hot_json as port_hot_json
from fmda_tpu_torch.analysis import hygiene as port_hygiene
from fmda_tpu_torch.analysis import protocol as port_protocol
from test_analysis import (
    LOCK_TP, METRICS_TN, METRICS_TP, SWALLOW_TP, TOPIC_CONFIG)

PACKAGE_DIR = pathlib.Path(fmda_tpu_torch.__file__).parent
REPO = PACKAGE_DIR.parent

#: reference path -> the port's counterpart, where they differ: the
#: reference's CLI module is ``cli.py``, the port's ``__main__.py``
PORT_PATH = {"cli.py": "__main__.py"}


def _listed_modules():
    """Every module a rule of either package lists by path: the tmp
    package carries them all, so no list reads as stale on either side."""
    out = set()
    for hyg in (ref_hygiene, port_hygiene):
        out.update(hyg.PRINT_ALLOWLIST + hyg.SPAN_CODE
                   + hyg.ROUTER_ROLE_MODULES + hyg.CHAOS_INSTRUMENTED)
    for hj in (ref_hot_json, port_hot_json):
        out.update(hj.SCOPE_MODULES + hj.CODEC_MODULES)
    for pr in (ref_protocol, port_protocol):
        out.update(pr.OP_MODULES + pr.KIND_MODULES + pr.V2_MODULES)
    return out


@pytest.fixture(scope="module")
def tmp_package(tmp_path_factory):
    root = tmp_path_factory.mktemp("pkg")
    for rel in _listed_modules():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text("")
    return root


def _port_source(src: str) -> str:
    return re.sub(r"\bfmda_tpu\b", "fmda_tpu_torch", src)


def _unport(text: str) -> str:
    return text.replace("fmda_tpu_torch", "fmda_tpu")


def _run(pkg, rule, sources, package_dir):
    modules = [pkg.ParsedModule.from_source(src, rel)
               for rel, src in sources.items()]
    ctx = pkg.LintContext(package_dir, modules)
    findings, suppressed = pkg.run_rules([rule], ctx)
    return findings, suppressed


def assert_parity(rule_name, sources, package_dir):
    """The reference's rule and the port's over the same fixtures."""
    ref_rule = getattr(ref, rule_name)()
    port_rule = getattr(port, rule_name)()
    assert ref_rule.id == port_rule.id
    want, want_supp = _run(ref, ref_rule, sources, package_dir)
    port_sources = {PORT_PATH.get(rel, rel): _port_source(src)
                    for rel, src in sources.items()}
    got, got_supp = _run(port, port_rule, port_sources, package_dir)
    back = {v: k for k, v in PORT_PATH.items()}
    got_rows = sorted((f.rule, back.get(f.path, f.path), f.line,
                       _unport(f.message), f.severity) for f in got)
    want_rows = sorted((f.rule, f.path, f.line, f.message, f.severity)
                       for f in want)
    assert got_rows == want_rows
    assert got_supp == want_supp
    return want


# ---------------------------------------------------------------------------
# The fixture sources of tests/test_analysis.py and tests/test_replay.py
# ---------------------------------------------------------------------------

LOCK_CASES = {
    "unguarded_read": {"mod.py": LOCK_TP},
    "guarded": {"mod.py": LOCK_TP.replace(
        "    def peek(self):\n        return self.n\n",
        "    def peek(self):\n        with self._lock:\n"
        "            return self.n\n")},
    "guarded_by_annotation": {"mod.py": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.state = {}  # guarded-by: _lock\n"
        "    def read(self):\n"
        "        return self.state\n")},
    "lock_free_hatch": {"mod.py": LOCK_TP.replace(
        "        return self.n",
        "        # lock-free: GIL-atomic int read, skew tolerated\n"
        "        return self.n")},
    "locked_suffix": {"mod.py": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0\n"
        "    def _peek_locked(self):\n"
        "        return self.n\n"
        "    def good(self):\n"
        "        with self._lock:\n"
        "            self.n += 1\n"
        "            return self._peek_locked()\n"
        "    def bad(self):\n"
        "        return self._peek_locked()\n")},
    "container_mutation": {"mod.py": (
        "import threading\n"
        "class Bus:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._logs = {}\n"
        "    def publish(self, topic, rec):\n"
        "        with self._lock:\n"
        "            self._logs[topic].append(rec)\n"
        "    def read(self, topic):\n"
        "        return list(self._logs[topic])\n")},
    "lockless_class": {"mod.py": (
        "class NoLock:\n"
        "    def __init__(self):\n"
        "        self.n = 0\n"
        "    def bump(self):\n"
        "        self.n += 1\n")},
    "match_statement": {"mod.py": (
        "import threading\n"
        "class C:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0\n"
        "    def bump(self, kind):\n"
        "        match kind:\n"
        "            case 'inc':\n"
        "                with self._lock:\n"
        "                    self.n += 1\n"
        "    def peek(self):\n"
        "        return self.n\n")},
    "ignore_hatch_with_reason": {"mod.py": LOCK_TP.replace(
        "        return self.n",
        "        return self.n  "
        "# lint: ignore[lock-discipline] scrape-time skew is fine")},
    "ignore_hatch_without_reason": {"mod.py": LOCK_TP.replace(
        "        return self.n",
        "        return self.n  # lint: ignore[lock-discipline]")},
}

THREAD_CASES = {
    "unjoined_non_daemon": {"obs/x.py": (
        "import threading\n"
        "class S:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self.run)\n"
        "        self._t.start()\n")},
    "daemon": {"obs/x.py": (
        "import threading\n"
        "class S:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self.run, daemon=True)\n"
        "        self._t.start()\n")},
    "joined_on_close": {"obs/x.py": (
        "import threading\n"
        "class S:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self.run)\n"
        "        self._t.start()\n"
        "    def stop(self):\n"
        "        self._t.join(timeout=5.0)\n")},
    "timer_cancel": {"obs/x.py": (
        "import threading\n"
        "class S:\n"
        "    def arm(self):\n"
        "        self._timer = threading.Timer(5.0, self.fire)\n"
        "        self._timer.start()\n"
        "    def close(self):\n"
        "        self._timer.cancel()\n")},
    "local_join": {"obs/y.py": (
        "from threading import Thread\n"
        "def run_all(jobs):\n"
        "    t = Thread(target=jobs.pop)\n"
        "    t.start()\n"
        "    t.join()\n")},
    "fire_and_forget": {"fleet/x.py": (
        "import threading\n"
        "def kick(fn):\n"
        "    threading.Thread(target=fn).start()\n")},
    "fire_and_forget_aliased": {"fleet/x.py": (
        "from threading import Thread as T\n"
        "def kick(fn):\n"
        "    T(target=fn).start()\n")},
    "annotated_unjoined": {"obs/x.py": (
        "import threading\n"
        "class S:\n"
        "    def start(self):\n"
        "        self._t: threading.Thread = "
        "threading.Thread(target=self.run)\n"
        "        self._t.start()\n")},
}

TOPIC_CASES = {
    "published_never_declared": {
        "config.py": TOPIC_CONFIG,
        "mod.py": 'def go(bus):\n    bus.publish("typo_topic", {})\n'},
    "clean": {
        "config.py": TOPIC_CONFIG,
        "mod.py": (
            'from fmda_tpu.config import TOPIC_A, '
            'TOPIC_FLEET_TICKS_PREFIX\n'
            'def go(bus, wid):\n'
            '    bus.publish("alpha", {})\n'
            '    bus.publish(TOPIC_A, {})\n'
            '    bus.publish(TOPIC_FLEET_TICKS_PREFIX + wid, {})\n'
            '    bus.publish_many("beta", [])\n'
            '    bus.publish(wid, {})\n'),
        "other.py": 'def listen(bus):\n    bus.consumer("beta")\n'},
}

METRIC_CASES = {
    "bad_registrations": {"mod.py": METRICS_TP},
    "clean": {"mod.py": METRICS_TN},
    "sample_vs_call_labels": {"mod.py": (
        "def a(registry):\n"
        "    registry.counter('served_total', topic='x')\n"
        "def b():\n"
        "    return {'counters': [\n"
        "        {'name': 'served_total', 'labels': {'stream': 'y'},\n"
        "         'value': 1}]}\n")},
}

JSON_BAD = "import json\ndef f(v):\n    return json.dumps(v)\n"
HOT_JSON_CASES = {
    "fleet": {"fleet/x.py": JSON_BAD},
    "aliased": {"runtime/x.py": (
        "import json as j\n"
        "from json import loads as parse\n"
        "def f(b):\n"
        "    return j.dumps(parse(b))\n")},
    "codec": {"stream/codec.py": JSON_BAD},
    "out_of_scope": {"obs/events.py": JSON_BAD},
    "hatched": {"fleet/x.py": (
        "import json\n"
        "def f(v):\n"
        "    # lint: ignore[hot-path-json] checkpoint metadata, not per-tick\n"
        "    return json.dumps(v)\n")},
}

LOGGING_CASES = {
    "print": {"stream/x.py": 'print("hi")\n'},
    "package_logger": {"stream/x.py": (
        'import logging\nlog = logging.getLogger("fmda_tpu.x")\n')},
    "foreign_logger": {"stream/x.py": (
        'import logging\nlog = logging.getLogger("requests")\n')},
    "root_and_dynamic_loggers": {"obs/x.py": (
        'import logging\n'
        'a = logging.getLogger()\n'
        'b = logging.getLogger(name)\n'
        'c = logging.getLogger(__name__)\n')},
    "cli_prints": {"cli.py": 'print("hi")\n'},
}

SPAN_CASES = {
    "wall_clock": {"obs/trace.py": "import time\nt = time.time()\n"},
    "monotonic": {"obs/trace.py": "import time\nt = time.perf_counter_ns()\n"},
}

CHAOS_BAD = ("from fmda_tpu.chaos import default_chaos\n"
             "_CHAOS = default_chaos()\n"
             "def pump():\n"
             "    _CHAOS.check('router.pump')\n")
CHAOS_CASES = {
    "unguarded": {"fleet/router.py": CHAOS_BAD},
    "guarded": {"fleet/router.py": CHAOS_BAD.replace(
        "    _CHAOS.check('router.pump')",
        "    if _CHAOS.enabled:\n"
        "        _CHAOS.check('router.pump')")},
}

VIRTUAL_CLOCK_CASES = {
    "wall_clock_calls": {"replay/driver.py": (
        "import time\n"
        "from time import sleep as zzz\n"
        "from datetime import datetime\n"
        "def pace():\n"
        "    t = time.time()\n"
        "    time.perf_counter()\n"
        "    zzz(0.1)\n"
        "    datetime.now()\n")},
    "telemetry_hatch": {"replay/driver.py": (
        "import time\n"
        "def progress():\n"
        "    # lint: ignore[virtual-clock] rows/s telemetry only\n"
        "    return time.perf_counter()\n")},
    "outside_replay": {"runtime/other.py": "import time\nt = time.time()\n",
                       "replay/__init__.py": "x = 1\n"},
    "stale_scope": {"runtime/other.py": "x = 1\n"},
}

_CALLEE = (
    "class W:\n"
    "    def _record(self):\n"
    "        self.metrics.count('control_errors')\n"
    "    def beat(self):\n"
    "        try:\n"
    "            self.bus.publish('t', {})\n"
    "        except ConnectionError:\n"
    "            self._record()\n"
)
_ROUTER_DROP = (
    "class R:\n"
    "    def age(self):\n"
    "        self.metrics.count('results_missing')\n"
    "    def shed(self, n):\n"
    "        self.metrics.count('ticks_dropped', n)\n"
)
COUNTED_LOSS_CASES = {
    "silent_swallow": {"fleet/x.py": SWALLOW_TP},
    "out_of_scope": {"data/x.py": SWALLOW_TP},
    "clean_shapes": {"fleet/x.py": (
        "class Pump:\n"
        "    def a(self):\n"
        "        try:\n"
        "            work()\n"
        "        except ValueError as e:\n"
        "            raise RuntimeError('no') from e\n"
        "    def b(self):\n"
        "        try:\n"
        "            work()\n"
        "        except ConnectionError:\n"
        "            self.metrics.count('bus_errors')\n"
        "    def c(self):\n"
        "        try:\n"
        "            work()\n"
        "        except OSError:\n"
        "            self.errors += 1\n"
        "    def d(self, skips, topic):\n"
        "        try:\n"
        "            work()\n"
        "        except OSError:\n"
        "            skips[topic] = skips.get(topic, 0) + 1\n")},
    "callee_counts": {"fleet/w.py": _CALLEE},
    "callee_does_not_count": {"fleet/w.py": _CALLEE.replace(
        "self.metrics.count('control_errors')", "pass")},
    "loss_free_hatch": {"fleet/x.py": SWALLOW_TP.replace(
        "        except ConnectionError:",
        "        # loss-free: teardown path, nothing in flight\n"
        "        except ConnectionError:")},
    "loss_free_wrapped": {"fleet/x.py": SWALLOW_TP.replace(
        "        except ConnectionError:",
        "        # loss-free: teardown path — nothing was in flight\n"
        "        # on this connection, so nothing can be lost\n"
        "        except ConnectionError:")},
    "loss_free_without_reason": {"fleet/x.py": SWALLOW_TP.replace(
        "        except ConnectionError:",
        "        # loss-free:\n"
        "        except ConnectionError:")},
    "vocabulary_dead_term": {
        "chaos/soak.py":
            'LOSS_COUNTERS = ("results_missing", "ghost_losses")\n',
        "fleet/router.py": (
            "class R:\n"
            "    def age(self):\n"
            "        self.metrics.count('results_missing')\n")},
    "drop_site_outside_identity": {
        "chaos/soak.py": 'LOSS_COUNTERS = ("results_missing",)\n',
        "fleet/router.py": _ROUTER_DROP},
    "drop_site_hatched": {
        "chaos/soak.py": 'LOSS_COUNTERS = ("results_missing",)\n',
        "fleet/router.py": _ROUTER_DROP.replace(
            "        self.metrics.count('ticks_dropped', n)",
            "        # lint: ignore[counted-loss] diagnostic-only series\n"
            "        self.metrics.count('ticks_dropped', n)")},
    "marker_does_not_bleed": {"fleet/x.py": (
        "class P:\n"
        "    def go(self):\n"
        "        try:\n"
        "            work()\n"
        "        except ValueError:\n"
        "            pass  # loss-free: benign probe\n"
        "        except ConnectionError:\n"
        "            pass\n")},
    "marker_on_code_line": {"fleet/x.py": (
        "class P:\n"
        "    def go(self):\n"
        "        try:\n"
        "            work()  # loss-free: stale note on a code line\n"
        "        except ConnectionError:\n"
        "            pass\n")},
}

_MEMBERSHIP = (
    "HELLO = 'hello'\n"
    "GOODBYE = 'goodbye'\n"
    "class H:\n"
    "    def _publish(self, kind, stats):\n"
    "        self.bus.publish('t', {'kind': kind, 'stats': stats})\n"
    "    def hello(self):\n"
    "        self._publish(HELLO, None)\n"
    "    def goodbye(self):\n"
    "        self._publish(GOODBYE, None)\n"
)
_TICKS_BARE = (
    "from fmda_tpu.stream import codec\n"
    "class R:\n"
    "    def send(self, msgs):\n"
    "        return codec.coalesce_ticks(msgs)\n"
)
_PACK_BARE = (
    "class G:\n"
    "    def publish(self, results):\n"
    "        return pack_results(results, self.labels)\n"
)
WIRE_CASES = {
    "consumed_only_op": {"fleet/wire.py": (
        "class S:\n"
        "    def dispatch(self, req):\n"
        "        op = req.get('op')\n"
        "        if op == 'publish':\n"
        "            return 1\n"
        "        if op == 'fetch_all':\n"
        "            return 2\n"
        "    def send(self):\n"
        "        self._request({'op': 'publish', 'topic': 't'})\n")},
    "produced_only_kind": {
        "fleet/router.py": (
            "class R:\n"
            "    def a(self):\n"
            "        self._enqueue({'kind': 'tick', 'seq': 1})\n"
            "    def b(self):\n"
            "        self._enqueue({'kind': 'mystery'})\n"),
        "fleet/worker.py": (
            "class W:\n"
            "    def apply(self, msg):\n"
            "        kind = msg.get('kind')\n"
            "        if kind == 'tick':\n"
            "            pass\n")},
    "constants_and_param_flow": {
        "fleet/membership.py": _MEMBERSHIP,
        "fleet/router.py": (
            "class R:\n"
            "    def handle(self, msg):\n"
            "        kind = msg.get('kind')\n"
            "        if kind in (HELLO, GOODBYE):\n"
            "            return True\n")},
    "keyword_param_flow": {
        "fleet/membership.py": (
            "HELLO = 'hello'\n"
            "class H:\n"
            "    def _publish(self, kind, stats):\n"
            "        self.bus.publish('t', {'kind': kind, 'stats': stats})\n"
            "    def hello(self):\n"
            "        self._publish(kind=HELLO, stats=None)\n"),
        "fleet/router.py": (
            "class R:\n"
            "    def handle(self, msg):\n"
            "        kind = msg.get('kind')\n"
            "        if kind == 'hello':\n"
            "            return True\n")},
    "local_constant": {
        "fleet/router.py": (
            "class R:\n"
            "    def stop_workers(self, graceful):\n"
            "        kind = 'drain_all' if graceful else 'stop'\n"
            "        self._enqueue({'kind': kind})\n"),
        "fleet/worker.py": (
            "class W:\n"
            "    def apply(self, msg):\n"
            "        kind = msg.get('kind')\n"
            "        if kind in ('drain_all', 'stop'):\n"
            "            self.shutdown()\n")},
    "wire_default_v2": {"fleet/worker.py": (
        "class W:\n"
        "    def apply(self, msg):\n"
        "        return int(msg.get('wire', 2))\n")},
    "wire_default_legacy": {"fleet/worker.py": (
        "class W:\n"
        "    def apply(self, msg):\n"
        "        return int(msg.get('wire', 1))\n")},
    "tick_blocks_without_lowering": {"fleet/router.py": _TICKS_BARE},
    "tick_blocks_lowered": {"fleet/router.py": _TICKS_BARE.replace(
        "from fmda_tpu.stream import codec\n",
        "from fmda_tpu.stream import codec\n"
        "from fmda_tpu.fleet.state import to_legacy_msgs\n").replace(
        "        return codec.coalesce_ticks(msgs)\n",
        "        if self.legacy:\n"
        "            return to_legacy_msgs(msgs)\n"
        "        return codec.coalesce_ticks(msgs)\n")},
    "pack_results_unguarded": {"runtime/gateway.py": _PACK_BARE},
    "pack_results_guarded": {"runtime/gateway.py": _PACK_BARE.replace(
        "        return pack_results(results, self.labels)\n",
        "        if self.result_blocks:\n"
        "            return pack_results(results, self.labels)\n"
        "        return results\n")},
}


def _params(cases):
    return pytest.mark.parametrize("case", sorted(cases))


# ---------------------------------------------------------------------------
# Parity: one parametrised test per framework-neutral rule
# ---------------------------------------------------------------------------


@_params(LOCK_CASES)
def test_lock_discipline_matches_the_reference(case, tmp_package):
    assert_parity("LockDisciplineRule", LOCK_CASES[case], tmp_package)


@_params(THREAD_CASES)
def test_thread_lifecycle_matches_the_reference(case, tmp_package):
    assert_parity("ThreadLifecycleRule", THREAD_CASES[case], tmp_package)


@_params(TOPIC_CASES)
def test_bus_topics_matches_the_reference(case, tmp_package):
    assert_parity("BusTopicRule", TOPIC_CASES[case], tmp_package)


@_params(METRIC_CASES)
def test_metric_names_matches_the_reference(case, tmp_package):
    assert_parity("MetricNamesRule", METRIC_CASES[case], tmp_package)


@_params(HOT_JSON_CASES)
def test_hot_path_json_matches_the_reference(case, tmp_package):
    assert_parity("HotPathJsonRule", HOT_JSON_CASES[case], tmp_package)


@_params(LOGGING_CASES)
def test_logging_hygiene_matches_the_reference(case, tmp_package):
    assert_parity("LoggingHygieneRule", LOGGING_CASES[case], tmp_package)


@_params(SPAN_CASES)
def test_span_wall_clock_matches_the_reference(case, tmp_package):
    assert_parity("SpanClockRule", SPAN_CASES[case], tmp_package)


@_params(CHAOS_CASES)
def test_chaos_guard_matches_the_reference(case, tmp_package):
    assert_parity("ChaosGuardRule", CHAOS_CASES[case], tmp_package)


@_params(VIRTUAL_CLOCK_CASES)
def test_virtual_clock_matches_the_reference(case, tmp_package):
    assert_parity("VirtualClockRule", VIRTUAL_CLOCK_CASES[case],
                  tmp_package)


@_params(COUNTED_LOSS_CASES)
def test_counted_loss_matches_the_reference(case, tmp_package):
    assert_parity("CountedLossRule", COUNTED_LOSS_CASES[case], tmp_package)


@_params(WIRE_CASES)
def test_wire_protocol_matches_the_reference(case, tmp_package):
    assert_parity("WireProtocolRule", WIRE_CASES[case], tmp_package)


def test_parity_fixtures_include_findings_for_every_rule(tmp_package):
    """The parity tests compare something: every rule's fixtures make the
    reference report at least one finding, and at least one case clean."""
    for rule_name, cases in (
            ("LockDisciplineRule", LOCK_CASES),
            ("ThreadLifecycleRule", THREAD_CASES),
            ("BusTopicRule", TOPIC_CASES),
            ("MetricNamesRule", METRIC_CASES),
            ("HotPathJsonRule", HOT_JSON_CASES),
            ("LoggingHygieneRule", LOGGING_CASES),
            ("SpanClockRule", SPAN_CASES),
            ("ChaosGuardRule", CHAOS_CASES),
            ("VirtualClockRule", VIRTUAL_CLOCK_CASES),
            ("CountedLossRule", COUNTED_LOSS_CASES),
            ("WireProtocolRule", WIRE_CASES)):
        counts = [len(_run(ref, getattr(ref, rule_name)(), sources,
                           tmp_package)[0]) for sources in cases.values()]
        assert max(counts) > 0 and min(counts) == 0, rule_name


def test_scope_lists_name_the_ports_counterparts():
    """The framework-neutral rules' scope lists are the reference's, paths
    and all, except where the port's tree differs: the command line."""
    assert port_hygiene.PRINT_ALLOWLIST == ("__main__.py", "obs/report.py")
    assert port_hygiene.LOGGER_NAMESPACE == "fmda_tpu_torch"
    assert port_hygiene.SPAN_CODE == ref_hygiene.SPAN_CODE
    assert port_hygiene.ROUTER_ROLE_MODULES == ref_hygiene.ROUTER_ROLE_MODULES
    assert port_hygiene.CHAOS_POINT_FLOORS == ref_hygiene.CHAOS_POINT_FLOORS
    assert port_hygiene.CHAOS_MIN_POINTS == ref_hygiene.CHAOS_MIN_POINTS == 7
    assert port_hot_json.SCOPE_MODULES == ref_hot_json.SCOPE_MODULES
    assert port_hot_json.CODEC_MODULES == ref_hot_json.CODEC_MODULES
    assert port_accounting.SCOPE_PREFIXES == ref_accounting.SCOPE_PREFIXES
    assert (port_accounting.CONSERVATION_DOMAINS
            == ref_accounting.CONSERVATION_DOMAINS)
    for name in ("OP_MODULES", "KIND_MODULES", "V2_MODULES"):
        assert getattr(port_protocol, name) == getattr(ref_protocol, name)
    for rel in (port_hygiene.PRINT_ALLOWLIST + port_hygiene.SPAN_CODE
                + port_hygiene.ROUTER_ROLE_MODULES
                + port_hygiene.CHAOS_INSTRUMENTED
                + port_hot_json.SCOPE_MODULES + port_hot_json.CODEC_MODULES):
        assert (PACKAGE_DIR / rel).is_file(), rel


@pytest.mark.parametrize("rule_name", ["LoggingHygieneRule",
                                       "HotPathJsonRule"])
def test_scope_lists_police_their_staleness(rule_name, tmp_path):
    findings, _ = _run(port, getattr(port, rule_name)(),
                       {"fleet/x.py": "x = 1\n"}, tmp_path)
    assert findings and all("stale" in f.message for f in findings)


# ---------------------------------------------------------------------------
# router-torch-import
# ---------------------------------------------------------------------------


def _router(src, rel="fleet/router.py"):
    return _run(port, port.RouterTorchImportRule(), {rel: src},
                PACKAGE_DIR)[0]


@pytest.mark.parametrize("src", [
    "import torch\n",
    "import torch.nn.functional as F\n",
    "from torch import nn\n",
    "import jax\n",
    "try:\n    import torch\nexcept ImportError:\n    torch = None\n",
    "class R:\n    import torch\n",
])
def test_router_torch_import_flags_module_scope_imports(src):
    findings = _router(src)
    assert len(findings) == 1 and "module-scope" in findings[0].message
    assert findings[0].rule == "router-torch-import"


def test_router_torch_import_clean_cases():
    deferred = ("def serve():\n"
                "    import torch\n"
                "    return torch.zeros(1)\n")
    assert _router(deferred) == []
    # a relative import of a sibling named like a framework is the
    # package's own module, and a worker may import torch at module scope
    assert _router("from .torch import x\n") == []
    assert _router("import torch\n", rel="fleet/worker.py") == []


def test_router_role_modules_of_the_tree_import_no_framework():
    ctx = port.collect_modules()
    findings, _ = port.run_rules([port.RouterTorchImportRule()], ctx)
    assert findings == []


# ---------------------------------------------------------------------------
# torch-api-drift
# ---------------------------------------------------------------------------


def _drift(sources):
    modules = [port.ParsedModule.from_source(src, rel)
               for rel, src in sources.items()]
    ctx = port.LintContext(PACKAGE_DIR, modules)
    findings, suppressed = port.run_rules([port.TorchApiDriftRule()], ctx)
    return findings, suppressed, ctx.reports["torch_api_drift"]


def test_torch_drift_flags_a_bogus_symbol_even_under_a_hatch():
    src = ("import torch\n"
           "x = torch.nn.functional.not_there"
           "  # lint: ignore[torch-api-drift] dodge the gate\n")
    findings, suppressed, rep = _drift({"serve/x.py": src})
    assert len(findings) == 1 and suppressed == 0
    assert "torch.nn.functional.not_there" in findings[0].message
    assert findings[0].severity == "error"
    assert rep["n_symbols"] == 1
    assert rep["symbols"]["torch.nn.functional.not_there"] == [
        {"path": "serve/x.py", "line": 2}]


def test_torch_drift_resolves_aliases():
    src = ("import torch\n"
           "import torch.nn.functional as F\n"
           "import torch.distributed as dist\n"
           "from torch import nn\n"
           "from torch.nn import functional\n"
           "def f():\n"
           "    import torch.cuda\n"
           "    return torch.cuda.Event, torch.cuda.current_stream\n"
           "a = F.relu\n"
           "b = nn.Linear\n"
           "c = functional.softmax\n"
           "d = dist.all_reduce\n"
           "e = torch.float32.is_floating_point\n")
    findings, _, rep = _drift({"models/x.py": src})
    assert findings == []
    assert rep["n_symbols"] == 0 and rep["n_sites"] >= 9
    assert rep["torch_version"]
    bad = _drift({"models/x.py": "from torch import nn\ny = nn.NotALayer\n"
                                 "import torch.nn.functional as F\n"
                                 "z = F.nope\n"})[0]
    assert sorted(f.message.rsplit(": ", 1)[1] for f in bad) == [
        "torch.nn.NotALayer", "torch.nn.functional.nope"]


def test_torch_drift_is_zero_baseline(tmp_path):
    src = "import torch\nx = torch.nn.functional.not_there\n"
    ctx = port.LintContext(
        PACKAGE_DIR, [port.ParsedModule.from_source(src, "ops/x.py")])
    path = tmp_path / "baseline.json"
    port.save_baseline(
        [{"rule": "torch-api-drift", "path": "ops/x.py",
          "message": "unresolved torch reference: "
                     "torch.nn.functional.not_there",
          "justification": "trying to grandfather drift"}], path)
    result = port.run_lint([port.TorchApiDriftRule()], ctx=ctx,
                           baseline_path=path)
    assert not result.ok
    assert len(result.new) == 1 and not result.baselined
    assert [e["rule"] for e in result.forbidden_baseline] == [
        "torch-api-drift"]


def test_torch_drift_never_calls_what_it_resolves(monkeypatch):
    """Resolution is attribute lookup: a referenced function is never
    called (``torch.cuda.init`` here would raise).  This is the function
    the resolver process runs."""
    import torch

    from fmda_tpu_torch.analysis.drift import _resolve_against_installed

    def boom(*a, **k):
        raise AssertionError("lint called a torch function")

    monkeypatch.setattr(torch.cuda, "init", boom)
    monkeypatch.setattr(torch.cuda, "is_available", boom)
    assert _resolve_against_installed("torch.cuda.init")
    assert _resolve_against_installed("torch.cuda.is_available")
    assert not _resolve_against_installed("torch.cuda.not_there")
    assert not torch.cuda.is_initialized()


def test_torch_drift_resolves_in_a_process_of_its_own():
    """The rule's resolver is a child process started before the other
    rules run; the run reaps it, and the rule's state is reset."""
    rule = port.TorchApiDriftRule()
    rule.start()
    child = rule._resolver
    assert child is not None and child.poll() is None
    ctx = port.LintContext(PACKAGE_DIR, [port.ParsedModule.from_source(
        "import torch\nx = torch.zeros\n", "ops/x.py")])
    findings, _ = port.run_rules([rule], ctx)
    assert findings == [] and child.returncode == 0
    assert rule._resolver is None and rule._refs == []
    assert ctx.reports["torch_api_drift"]["n_sites"] == 1


# ---------------------------------------------------------------------------
# booked-launch
# ---------------------------------------------------------------------------


def _booked(sources):
    modules = [port.ParsedModule.from_source(src, rel)
               for rel, src in sources.items()]
    ctx = port.LintContext(PACKAGE_DIR, modules)
    findings, _ = port.run_rules([port.BookedLaunchRule()], ctx)
    return findings, ctx.reports["booked_launch"]


#: the no-launch entries called as the tree calls them
_NO_LAUNCH_CALLS = (
    "def plans(lib, cell, err):\n"
    "    lib.fmda_flash_fwd_plan(1, 1, 1, 1, 4, None)\n"
    "    lib.fmda_flash_bwd_plan(1, 1, 1, 1, 4, 0, None)\n"
    "    lib.fmda_scan_dw_splits(1, 1, 1, 3, 0)\n"
    "    lib.fmda_lstm_persist_plan(1, 1, 2, 0, None)\n"
    "    lib.fmda_gru_wide_bwd_step_plan(1, 64, 2, 0, None)\n"
    "    lib.fmda_gru_wide_bwd_scan_prepare_bf16(None)\n"
    "    lib.fmda_cuda_error_string(err)\n"
    "    getattr(lib, f'fmda_{cell}_scan_fwd_plan')(1, 1, 4, 0, None)\n"
)


def test_booked_launch_flags_a_raw_kernel_call():
    raw = ("from fmda_tpu_torch.ops import _cuda_lib\n"
           "def launch(xp):\n"
           "    lib = _cuda_lib.load()\n"
           "    return lib.fmda_gru_scan_fwd_f32(xp.data_ptr())\n")
    findings, _ = _booked({"ops/x.py": raw, "ops/plans.py": _NO_LAUNCH_CALLS})
    assert len(findings) == 1
    f = findings[0]
    assert (f.rule, f.path, f.line) == ("booked-launch", "ops/x.py", 4)
    assert "fmda_gru_scan_fwd_f32" in f.message
    assert "call_booked" in f.message


def test_booked_launch_clean_through_call_booked():
    booked = ("from fmda_tpu_torch.ops import _cuda_lib, call_booked\n"
              "def launch(xp):\n"
              "    lib = _cuda_lib.load()\n"
              "    return call_booked('gru_scan_fwd', (1,),\n"
              "                       lib.fmda_gru_scan_fwd_f32,\n"
              "                       (xp.data_ptr(),))\n")
    findings, rep = _booked({"ops/x.py": booked,
                             "ops/plans.py": _NO_LAUNCH_CALLS})
    assert findings == [] and rep["booked_sites"] == 1


def test_booked_launch_follows_a_bound_entry():
    src = ("def launch(lib, tag, args):\n"
           "    fn = getattr(lib, f'fmda_ssm_tick_{tag}')\n"
           "    fn.restype = int\n"
           "    return fn(*args)\n"
           "def booked(lib, tag, args):\n"
           "    fn = getattr(lib, f'fmda_ssm_tick_{tag}')\n"
           "    return call_booked('ssm_tick', (), fn, args)\n")
    findings, rep = _booked({"parallel/x.py": src,
                             "ops/plans.py": _NO_LAUNCH_CALLS})
    assert [(f.path, f.line) for f in findings] == [("parallel/x.py", 4)]
    assert "through `fn`" in findings[0].message
    assert rep["booked_sites"] == 1


def test_booked_launch_pattern_entries_resolve_against_the_library():
    """An f-string entry is launch-free only when every exported entry it
    can name is: ``fmda_{cell}_scan_fwd_plan`` is, ``fmda_gru_scan_fwd_{t}``
    (which also names the launching f32/bf16 entries) is not."""
    src = ("def f(lib, t):\n"
           "    return getattr(lib, f'fmda_gru_scan_fwd_{t}')(1)\n")
    findings, _ = _booked({"ops/x.py": src, "ops/plans.py": _NO_LAUNCH_CALLS})
    assert len(findings) == 1 and "fmda_gru_scan_fwd_*" in findings[0].message


def test_booked_launch_scope_is_ops_and_parallel():
    raw = "def f(lib):\n    return lib.fmda_ssm_step_f32()\n"
    findings, _ = _booked({"serve/x.py": raw,
                           "ops/plans.py": _NO_LAUNCH_CALLS})
    assert findings == []


def test_booked_launch_flags_a_stale_no_launch_entry(monkeypatch):
    from fmda_tpu_torch.analysis import booked_launch

    monkeypatch.setattr(booked_launch, "NO_LAUNCH_ENTRIES",
                        port.NO_LAUNCH_ENTRIES + ("fmda_gone_plan",))
    findings, _ = _booked({"ops/plans.py": _NO_LAUNCH_CALLS})
    assert [f.message for f in findings] == [
        "stale NO_LAUNCH_ENTRIES entry: fmda_gone_plan is not exported "
        "by the library's C sources"]
    # exported but called nowhere is stale too
    monkeypatch.undo()
    findings, _ = _booked({"ops/x.py": "x = 1\n"})
    assert len(findings) == len(port.NO_LAUNCH_ENTRIES)
    assert all("is called nowhere" in f.message for f in findings)


def test_booked_launch_on_the_tree():
    """Every launching C call of ops/ goes through call_booked: the
    eleven kernels' wrappers (some share a call site), and nothing raw
    but the six launch-free entries."""
    ctx = port.collect_modules()
    findings, _ = port.run_rules([port.BookedLaunchRule()], ctx)
    assert findings == []
    rep = ctx.reports["booked_launch"]
    assert rep["booked_sites"] >= 9
    assert set(port.NO_LAUNCH_ENTRIES) <= set(rep["exported"])
    launching = set(rep["exported"]) - set(port.NO_LAUNCH_ENTRIES)
    assert {"fmda_gru_scan_fwd_f32", "fmda_ssm_tick_bf16",
            "fmda_flash_bwd_f32", "fmda_scan_dw_f32"} <= launching


# ---------------------------------------------------------------------------
# Engine, baseline, SARIF
# ---------------------------------------------------------------------------


def test_catalog_has_fourteen_rules():
    catalog = port.rule_catalog()
    assert len(catalog) == 14
    assert set(catalog) == {
        "logging-hygiene", "span-wall-clock", "router-torch-import",
        "chaos-guard", "lock-discipline", "bus-topics", "metric-names",
        "hot-path-json", "counted-loss", "wire-protocol",
        "thread-lifecycle", "virtual-clock", "booked-launch",
        "torch-api-drift"}
    assert set(port.rule_catalog(drift=False)) == set(catalog) - {
        "torch-api-drift"}


def test_every_reference_rule_is_matched_or_explained():
    """The reference's sixteen rules: eleven kept by id, three with a
    counterpart, two named in the package docstring with the reason they
    have none."""
    ref_ids = set(ref.rule_catalog(drift=True))
    assert len(ref_ids) == 16
    counterparts = {"router-jax-import": "router-torch-import",
                    "jax-api-drift": "torch-api-drift",
                    "tracked-jit": "booked-launch"}
    none = {"jit-purity", "compat-required"}
    port_ids = set(port.rule_catalog())
    for rid in ref_ids:
        if rid in counterparts:
            assert counterparts[rid] in port_ids
        elif rid in none:
            assert f"``{rid}``" in port.__doc__
        else:
            assert rid in port_ids, rid


def test_baseline_round_trip_and_staleness(tmp_path):
    f1 = port.Finding("lock-discipline", "a.py", 3, "A.m: read of self.x")
    f2 = port.Finding("lock-discipline", "b.py", 9, "B.m: read of self.y")
    path = tmp_path / "baseline.json"
    port.save_baseline(
        [{**f1.as_dict(), "justification": "deliberate snapshot read"}],
        path)
    entries = port.load_baseline(path)
    new, old, stale = port.apply_baseline([f1, f2], entries)
    assert [f.key for f in old] == [f1.key]
    assert [f.key for f in new] == [f2.key]
    assert not stale
    moved = port.Finding(f1.rule, f1.path, 77, f1.message)
    new, old, stale = port.apply_baseline([moved], entries)
    assert old and not new and not stale
    new, old, stale = port.apply_baseline([], entries)
    assert stale and stale[0]["path"] == "a.py"


@pytest.mark.parametrize("doc, match", [
    ({"version": 1, "findings": [{"rule": "r", "path": "p.py",
                                  "message": "m", "justification": "  "}]},
     "justification"),
    ({"version": 99, "findings": []}, "version"),
    ({"version": 1, "findings": [{"rule": "r", "message": "m",
                                  "justification": "why"}]}, "path"),
])
def test_malformed_baselines_raise(tmp_path, doc, match):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match=match):
        port.load_baseline(path)


def test_shipped_baseline_is_empty():
    doc = json.loads(port.DEFAULT_BASELINE.read_text())
    assert doc == {"version": 1, "findings": []}
    assert port.DEFAULT_BASELINE.parent == PACKAGE_DIR / "analysis"


def test_sarif_document_schema():
    result = port.LintResult(
        new=[port.Finding("counted-loss", "fleet/x.py", 3, "swallowed",
                          "warning")],
        baselined=[port.Finding("lock-discipline", "obs/y.py", 7,
                                "old debt", "warning")],
    )
    doc = port.to_sarif(result, port.default_rules(drift=False))
    assert set(doc) == {"$schema", "version", "runs"}
    run = doc["runs"][0]
    ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {"booked-launch", "router-torch-import", "counted-loss"} <= ids
    new, old = run["results"]
    loc = new["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"] == {"uri": "fmda_tpu_torch/fleet/x.py",
                                       "uriBaseId": "SRCROOT"}
    assert loc["region"] == {"startLine": 3}
    assert old["suppressions"][0]["kind"] == "external"


# ---------------------------------------------------------------------------
# The lint command
# ---------------------------------------------------------------------------


def test_lint_json_schema(capsys):
    rc = port_main(["lint", "--json", "--no-drift"])
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {"ok", "n_modules", "new", "baselined",
                        "suppressed", "stale_baseline",
                        "forbidden_baseline", "reports"}
    assert doc["ok"] is True and rc == 0
    assert doc["n_modules"] > 100
    assert {"bus_topics", "booked_launch", "counted_loss",
            "wire_protocol"} <= set(doc["reports"])
    assert "torch_api_drift" not in doc["reports"]


@pytest.mark.parametrize("argv, err", [
    (["--rule", "no-such-rule"], "unknown rule"),
    (["--drift-report", "{tmp}/drift.json"], "--no-drift"),
    (["--baseline", "{tmp}/nope.json"], "baseline file not found"),
])
def test_lint_usage_errors_exit_2(capsys, tmp_path, argv, err):
    argv = [a.format(tmp=tmp_path) for a in argv]
    rc = port_main(["lint", "--no-drift", *argv])
    assert rc == 2
    assert err in capsys.readouterr().err
    assert not (tmp_path / "drift.json").exists()


def test_lint_malformed_baseline_exits_2(capsys, tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1, "findings": [
        {"rule": "lock-discipline", "path": "a.py", "message": "m",
         "justification": ""}]}))
    rc = port_main(["lint", "--no-drift", "--baseline", str(path)])
    assert rc == 2
    assert "justification" in capsys.readouterr().err


def test_lint_stale_baseline_entry_exits_1(capsys, tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1, "findings": [
        {"rule": "lock-discipline", "path": "gone.py",
         "message": "paid off long ago",
         "justification": "was deliberate once"}]}))
    rc = port_main(["lint", "--no-drift", "--baseline", str(path)])
    captured = capsys.readouterr()
    assert rc == 1
    assert "stale baseline entry" in captured.err
    assert "1 stale baseline entry" in captured.out


def test_lint_new_finding_exits_1(capsys, monkeypatch, tmp_path):
    """A tree with a violation fails the gate: the port's package dir
    swapped for a copy of one module with a print in it."""
    pkg = tmp_path / "pkg"
    (pkg / "stream").mkdir(parents=True)
    (pkg / "stream" / "x.py").write_text('print("hi")\n')
    import fmda_tpu_torch.analysis.engine as engine

    monkeypatch.setattr(engine, "PACKAGE_DIR", pkg)
    rc = port_main(["lint", "--no-drift", "--rule", "logging-hygiene",
                    "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1 and doc["ok"] is False
    assert sorted((f["path"], f["line"]) for f in doc["new"]) == sorted(
        [("stream/x.py", 1)]
        + [(rel, 0) for rel in port_hygiene.PRINT_ALLOWLIST])


def test_lint_single_rule_filter(capsys, tmp_path):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1, "findings": [
        {"rule": "counted-loss", "path": "gone.py", "message": "m",
         "justification": "another rule's entry"}]}))
    rc = port_main(["lint", "--rule", "lock-discipline", "--no-drift",
                    "--baseline", str(path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0 new finding(s)" in out
    # rule filtering must not report other rules' baseline as stale
    assert "0 stale baseline entries" in out


def test_lint_sarif_writes_document(tmp_path):
    out = tmp_path / "lint.sarif"
    rc = port_main(["lint", "--no-drift", "--sarif", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["version"] == "2.1.0"
    assert doc["runs"][0]["results"] == []
    ids = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert "booked-launch" in ids and "torch-api-drift" not in ids


def test_lint_takes_no_device():
    with pytest.raises(SystemExit) as exc:
        port_main(["lint", "--device", "cpu"])
    assert exc.value.code == 2


def test_lint_command_in_a_clean_interpreter(tmp_path):
    """``python -m fmda_tpu_torch lint`` exits 0 on the tree and writes
    the drift inventory without loading torch into its own process (the
    resolver has a process of its own), let alone initialising CUDA."""
    report = tmp_path / "drift.json"
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['fmda_tpu_torch', 'lint', '--drift-report', "
        f"{str(report)!r}]\n"
        "try:\n"
        "    runpy.run_module('fmda_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "assert 'torch' not in sys.modules\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'fmda_tpu.'))\n"
        "               for m in sys.modules)\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "0 new finding(s), 0 baselined" in proc.stdout
    doc = json.loads(report.read_text())
    assert {"torch_version", "n_symbols", "n_sites", "symbols"} <= set(doc)
    assert doc["n_symbols"] == 0 and doc["symbols"] == {}


# ---------------------------------------------------------------------------
# THE gate: the whole catalog over the port's own tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_lint_result():
    return port.run_lint(port.default_rules())


def test_port_is_lint_clean_against_baseline(port_lint_result):
    """``python -m fmda_tpu_torch lint`` exiting 0: zero findings across
    all fourteen rules, an empty baseline, no stale or forbidden entry,
    and no torch symbol the installed torch lacks."""
    result = port_lint_result
    assert result.n_modules > 100
    assert not result.new, "new static-analysis findings:\n" + "\n".join(
        f.format() for f in result.new)
    assert not result.baselined and port.load_baseline() == []
    assert not result.stale_baseline and not result.forbidden_baseline
    rep = result.reports["torch_api_drift"]
    assert rep["n_symbols"] == 0, json.dumps(rep["symbols"], indent=2)
    assert rep["n_sites"] > 100


def test_port_conservation_and_wire_harvests(port_lint_result):
    """The cross-checks read the port's live vocabulary, as the
    reference's read its own."""
    rep = port_lint_result.reports["counted_loss"]
    declared = {n for names in rep["vocabulary"].values() for n in names}
    assert {"results_missing", "migration_buffer_shed",
            "inflight_dropped_on_close", "stale_results_dropped"} <= declared
    assert declared <= set(rep["registered_counters"])
    assert set(rep["pipeline_loss_fields"]) == {
        "dropped_unjoinable", "pending_joins",
        "journal_pending", "journal_shed"}
    wire = port_lint_result.reports["wire_protocol"]
    assert {"tick", "tick_block", "open", "drain_session", "session_state",
            "result_block", "hello", "heartbeat", "goodbye"} <= set(
        wire["kinds"]["produced"])
    assert {"publish", "read", "batch", "hello"} <= set(
        wire["ops"]["produced"])
    assert port_lint_result.reports["chaos_points"] >= 7


# ---------------------------------------------------------------------------
# The sites the gate's first run on the port found
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", [
    "runtime/gateway.py", "stream/bus.py", "obs/device.py"])
def test_lock_sites_hold_the_contract(rel):
    """``FleetGateway._complete_locked`` (it reads ``weights_version``,
    which ``hot_swap`` writes under the lock) and
    ``InProcessBus._check_topic_locked`` are reached only under the lock
    and say so by the ``_locked`` suffix; ``KernelLedger.begin``'s
    sampling draw is a declared lock-free read."""
    ctx = port.collect_modules()
    ctx.modules = [m for m in ctx.modules if m.rel == rel]
    findings, _ = port.run_rules([port.LockDisciplineRule()], ctx)
    assert findings == []


def test_locked_methods_are_called_only_under_the_lock():
    from fmda_tpu_torch.runtime.gateway import FleetGateway
    from fmda_tpu_torch.stream.bus import InProcessBus

    assert hasattr(FleetGateway, "_complete_locked")
    assert hasattr(FleetGateway, "_complete_counted_locked")
    assert not hasattr(FleetGateway, "_complete")
    assert hasattr(InProcessBus, "_check_topic_locked")
    bus = InProcessBus(["a"])
    with pytest.raises(KeyError, match="unknown topic"):
        bus.publish("b", {})
    with pytest.raises(KeyError, match="unknown topic"):
        bus.read("b", 0)


def test_restored_hatches_match_the_reference():
    """The hatches the port dropped are back at the same sites, with the
    reference's reasons: every replay wall-clock read and the journal's
    two JSON sites, by rule and by count."""
    for rel, rule, n in (("replay/driver.py", "virtual-clock", 4),
                         ("replay/reference.py", "virtual-clock", 5),
                         ("stream/journal.py", "hot-path-json", 2)):
        ours = (PACKAGE_DIR / rel).read_text()
        theirs = (REPO / "fmda_tpu" / rel).read_text()
        tag = f"# lint: ignore[{rule}] "
        mine = sorted(line.strip() for line in ours.splitlines()
                      if tag in line)
        assert len(mine) == n
        assert mine == sorted(line.strip() for line in theirs.splitlines()
                              if tag in line)


def test_analysis_modules_are_in_the_isolation_walk():
    """``tests/test_torch_isolation.py`` imports every port module in a
    clean interpreter and scans every source file: the walk reaches the
    analysis package without edits."""
    from test_torch_isolation import _port_modules

    names = {f"fmda_tpu_torch.analysis.{p.stem}"
             for p in (PACKAGE_DIR / "analysis").glob("*.py")
             if p.stem != "__init__"}
    assert names | {"fmda_tpu_torch.analysis"} <= set(_port_modules())
