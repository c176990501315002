"""fmda_tpu_torch.fleet against fmda_tpu.fleet, on the CPU.

- The ownership hash ring and the membership fold: the same tables and
  the same join/leave/reap verdicts from the same messages.
- The carried-state, row and result-block codecs: for the same arrays,
  the reference's bytes, in both wire dialects.
- An in-process fleet on a fake clock (router and workers on one
  InProcessBus, every value pushed through the wire codec) run on JAX
  and on the port with the same weights (``interop.params_from_flax``):
  every published result equal within 1e-5 (float32), the same ``seq``
  streams, ownership tables and counters, across a live migration, a
  graceful leave, a worker death (``sessions_lost_state`` counted once),
  a router takeover, and faults injected through each package's chaos
  runtime (the same raises, sleeps, ``on_fault`` calls and chaos metric
  families).  Parametrised over the cell families and both wire
  dialects, as the reference's ``MIGRATION_CASES``.
- The port's own migrated run against its unmigrated single-gateway run:
  bit for bit, the reference's contract.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fmda_tpu.chaos.inject as jax_chaos
import fmda_tpu.config as jax_config
import fmda_tpu.fleet.hashring as jax_hashring
import fmda_tpu.fleet.membership as jax_membership
import fmda_tpu.fleet.state as jax_state
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.fleet.router import FleetRouter as JaxFleetRouter
from fmda_tpu.fleet.worker import FleetWorker as JaxFleetWorker
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.obs.observability import Observability as JaxObservability
from fmda_tpu.stream import codec as jax_codec
from fmda_tpu.stream.bus import InProcessBus as JaxBus

import fmda_tpu_torch.chaos.inject as port_chaos
import fmda_tpu_torch.config as port_config
import fmda_tpu_torch.fleet.hashring as port_hashring
import fmda_tpu_torch.fleet.membership as port_membership
import fmda_tpu_torch.fleet.state as port_state
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.fleet.router import FleetRouter, NoLiveWorkers
from fmda_tpu_torch.fleet.worker import FleetWorker
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.obs.observability import Observability
from fmda_tpu_torch.runtime import BatcherConfig, FleetGateway, SessionPool
from fmda_tpu_torch.stream import codec
from fmda_tpu_torch.stream.bus import InProcessBus

TOL = 1e-5
FEATS, HIDDEN, WINDOW = 6, 5, 4
CELLS = ("gru", "lstm", "ssm")
#: every family on the binary wire, the JSON fallback for gru and ssm
MIGRATION_CASES = ([("binary", c) for c in CELLS]
                   + [("json", "gru"), ("json", "ssm")])


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _weights(cell, seed=0):
    """The reference's init for ``cell`` and the port's state_dict of the
    same weights."""
    fields = dict(hidden_size=HIDDEN, n_features=FEATS, output_size=4,
                  dropout=0.0, bidirectional=False, cell=cell)
    jax_cfg = jax_config.ModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, FEATS)))["params"])
    return ((jax_cfg, params),
            (port_config.ModelConfig(**fields), params_from_flax(params)))


class _Side:
    """One framework's fleet classes, so a scenario runs on either."""

    def __init__(self, name, cfg_mod, router, worker, bus, norm, codec_mod,
                 model, worker_kw, chaos, obs):
        self.name, self.cfg, self.Router, self.Worker = (
            name, cfg_mod, router, worker)
        self.Bus, self.Norm, self.codec = bus, norm, codec_mod
        self.model, self.worker_kw = model, worker_kw
        self.chaos, self.Observability = chaos, obs


def _sides(cell):
    ref_model, port_model = _weights(cell)
    return (
        _Side("jax", jax_config, JaxFleetRouter, JaxFleetWorker, JaxBus,
              JaxNormParams, jax_codec, ref_model, {}, jax_chaos,
              JaxObservability),
        _Side("port", port_config, FleetRouter, FleetWorker, InProcessBus,
              NormParams, codec, port_model, {"device": "cpu"}, port_chaos,
              Observability),
    )


class CodecRoundTripBus:
    """An InProcessBus front that pushes every published value through
    one package's wire codec in a fixed dialect: the value transformation
    a SocketBus link applies."""

    def __init__(self, inner, codec_mod, fmt):
        self._inner, self._codec, self._fmt = inner, codec_mod, fmt

    def _trip(self, value):
        payload = self._codec.encode_payload(value,
                                             binary=self._fmt == "binary")
        return self._codec.decode_payload(payload)[0]

    def publish(self, topic, value):
        return self._inner.publish(topic, self._trip(value))

    def publish_many(self, topic, values):
        return self._inner.publish_many(topic,
                                        [self._trip(v) for v in values])

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _fleet_cfg(side):
    return side.cfg.FleetTopologyConfig(heartbeat_interval_s=0.0,
                                        heartbeat_timeout_s=50.0)


def _runtime(side):
    return side.cfg.RuntimeConfig(capacity=8, window=WINDOW,
                                  bucket_sizes=(1,), max_linger_ms=0.0,
                                  pipeline_depth=0)


def _worker(side, wid, bus, clock):
    cfg, params = side.model
    return side.Worker(wid, bus, cfg, params, config=_fleet_cfg(side),
                       runtime=_runtime(side), clock=clock,
                       precompile=False, **side.worker_kw)


def _topology(side, worker_ids, *, all_ids=None, wire=None, start=True):
    clock = FakeClock()
    bus = side.Bus(tuple(side.cfg.DEFAULT_TOPICS)
                   + side.cfg.fleet_topics(all_ids or worker_ids))
    if wire is not None:
        bus = CodecRoundTripBus(bus, side.codec, wire)
    workers = {w: _worker(side, w, bus, clock) for w in worker_ids}
    router = side.Router(bus, _fleet_cfg(side), n_features=FEATS,
                         clock=clock)
    if start:
        for w in workers.values():
            w.start()
        router.pump()
    return router, workers, bus, clock


def _cycle(router, workers, got):
    router.pump()
    for w in workers:
        if not w.stopped:
            w.step()
    for res in router.pump():
        got.setdefault(res.session_id, []).append(
            (res.seq, np.asarray(res.probabilities, np.float32)))


def _inputs(n_sessions, n_rounds, seed=1):
    rng = np.random.default_rng(seed)
    sids = [f"T{i}" for i in range(n_sessions)]
    norms, rows = {}, {}
    for sid in sids:
        mn = rng.normal(size=FEATS).astype(np.float32)
        norms[sid] = (mn, mn + 2.0)
        rows[sid] = rng.normal(size=(n_rounds, FEATS)).astype(np.float32)
    return sids, norms, rows


def _outcome(router, got, sids):
    counters = router.metrics.counters
    return {
        "results": got,
        "owners": {sid: router.table.owner_of(sid) for sid in sids},
        "table": router.table.to_wire(),
        "counters": {k: counters.get(k, 0) for k in (
            "migrations_completed", "migration_replayed_ticks",
            "sessions_lost_state", "workers_dead", "sessions_adopted",
            "results_missing", "ticks_routed")},
    }


def _assert_same_outcome(port, ref):
    assert port["owners"] == ref["owners"]
    assert port["table"] == ref["table"]
    assert port["counters"] == ref["counters"]
    assert sorted(port["results"]) == sorted(ref["results"])
    for sid, ref_res in ref["results"].items():
        got = port["results"][sid]
        assert [s for s, _ in got] == [s for s, _ in ref_res], sid
        for (_, a), (_, b) in zip(got, ref_res):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL,
                                       err_msg=sid)


# -- scenarios, each run on either package ------------------------------------


def _run_migration(side, wire, n_rounds=12):
    """w0 alone; w1 joins at round 5 with a round submitted during the
    handoff (the router buffers and replays it)."""
    sids, norms, rows = _inputs(5, n_rounds)
    router, workers, bus, clock = _topology(side, ["w0"],
                                            all_ids=["w0", "w1"], wire=wire)
    for sid in sids:
        router.open_session(sid, side.Norm(*norms[sid]))
    got, live = {}, list(workers.values())
    for r in range(n_rounds):
        if r == 5:
            w1 = _worker(side, "w1", bus, clock)
            live.append(w1)
            w1.start()
            router.pump()  # hello -> rebalance -> drain markers
            for sid in sids:
                router.submit(sid, rows[sid][r])
            for _ in range(4):
                _cycle(router, live, got)
            continue
        for sid in sids:
            router.submit(sid, rows[sid][r])
        _cycle(router, live, got)
    for _ in range(8):
        _cycle(router, live, got)
    return _outcome(router, got, sids)


def _run_leave(side, wire):
    sids, norms, rows = _inputs(6, 7, seed=2)
    router, workers, _, _ = _topology(side, ["w0", "w1"], wire=wire)
    for sid in sids:
        router.open_session(sid, side.Norm(*norms[sid]))
    got = {}
    for r in range(3):
        for sid in sids:
            router.submit(sid, rows[sid][r])
        _cycle(router, workers.values(), got)
    router.request_leave("w0")
    for _ in range(10):
        _cycle(router, workers.values(), got)
    assert workers["w0"].stopped and workers["w0"].pool.n_active == 0
    for r in range(3, 7):
        for sid in sids:
            router.submit(sid, rows[sid][r])
        _cycle(router, workers.values(), got)
    for _ in range(4):
        _cycle(router, workers.values(), got)
    return _outcome(router, got, sids)


def _run_death(side, wire):
    sids, norms, rows = _inputs(6, 5, seed=3)
    router, workers, _, clock = _topology(side, ["w0", "w1"], wire=wire)
    for sid in sids:
        router.open_session(sid, side.Norm(*norms[sid]))
    got = {}
    for r in range(3):
        for sid in sids:
            router.submit(sid, rows[sid][r])
        _cycle(router, workers.values(), got)
    victim = router.table.owner_of(sids[0])
    survivor = "w1" if victim == "w0" else "w0"
    workers[victim].stopped = True  # silent death: no goodbye
    clock.advance(60.0)  # past heartbeat_timeout_s
    workers[survivor].step()
    router.pump()
    for r in range(3, 5):
        for sid in sids:
            router.submit(sid, rows[sid][r])
        _cycle(router, [workers[survivor]], got)
    for _ in range(5):
        _cycle(router, [workers[survivor]], got)
    out = _outcome(router, got, sids)
    out["victim"] = victim
    return out


def _run_takeover(side, wire, n_rounds=12):
    """Router #1 serves rounds 0-5 and vanishes; router #2 starts from the
    end of the control topic, adopts every session from the worker's
    report and serves rounds 6-11."""
    sids, norms, rows = _inputs(4, n_rounds, seed=4)
    router, workers, bus, clock = _topology(side, ["w0"], wire=wire)
    for sid in sids:
        router.open_session(sid, side.Norm(*norms[sid]))
    got = {}
    for r in range(6):
        for sid in sids:
            router.submit(sid, rows[sid][r])
        _cycle(router, workers.values(), got)
    for _ in range(4):
        _cycle(router, workers.values(), got)
    router2 = side.Router(bus, _fleet_cfg(side), n_features=FEATS,
                          clock=clock, from_end=True)
    for _ in range(6):
        for w in workers.values():
            w.step()
        router2.pump()
        if len(router2.open_session_ids()) == len(sids):
            break
    for r in range(6, n_rounds):
        for sid in sids:
            router2.submit(sid, rows[sid][r])
        _cycle(router2, workers.values(), got)
    for _ in range(4):
        _cycle(router2, workers.values(), got)
    return _outcome(router2, got, sids)


def _run_chaos(side, wire, n_rounds=8):
    """Faults armed through the package's process-default chaos runtime,
    the one the router and worker modules captured at import: a kill
    window at ``worker.step`` for rounds 2-3 (every worker's step raises
    ``ChaosFault``, which the test's loop counts and retries as the
    worker's run loop does) and a delay at ``router.pump`` in round 5
    (recorded, not slept).  Every tick is still served, in order."""
    sids, norms, rows = _inputs(6, n_rounds, seed=5)
    router, workers, _, _ = _topology(side, ["w0", "w1"], wire=wire)
    for sid in sids:
        router.open_session(sid, side.Norm(*norms[sid]))
    obs = side.Observability()  # its chaos collector counts the faults
    chaos = side.chaos.default_chaos()
    faults, sleeps, bus_errors, got = [], [], [], {}
    chaos.configure(enabled=True, sleep_fn=sleeps.append,
                    plan=side.chaos.FaultPlan(n_rounds, (
                        side.chaos.FaultEvent(2, "kill", "worker.step",
                                              duration=2),
                        side.chaos.FaultEvent(5, "delay", "router.pump",
                                              delay_s=0.25))))
    chaos.on_fault = lambda *fault: faults.append(fault)
    try:
        for r in range(n_rounds + 6):
            chaos.advance(r)
            if r < n_rounds:
                for sid in sids:
                    router.submit(sid, rows[sid][r])
            router.pump()
            for wid, w in workers.items():
                try:
                    w.step()
                except ConnectionError:
                    bus_errors.append((r, wid))
            for res in router.pump():
                got.setdefault(res.session_id, []).append(
                    (res.seq, np.asarray(res.probabilities, np.float32)))
        counted = [f for f in obs.snapshot()["counters"]
                   if f["name"] == "chaos_injected_total"]
        families = side.chaos.chaos_families(chaos)
    finally:
        chaos.configure(enabled=False, plan=side.chaos.FaultPlan(0),
                        sleep_fn=time.sleep)
        chaos.on_fault = None
    out = _outcome(router, got, sids)
    out.update(faults=faults, sleeps=sleeps, bus_errors=bus_errors,
               counted=counted, families=families)
    return out


def _both(cell, run, *args):
    ref_side, port_side = _sides(cell)
    return run(port_side, *args), run(ref_side, *args)


@pytest.mark.parametrize("wire,cell", MIGRATION_CASES)
def test_live_migration_matches_the_reference(wire, cell):
    port, ref = _both(cell, _run_migration, wire)
    _assert_same_outcome(port, ref)
    assert port["counters"]["migrations_completed"] >= 1
    assert port["counters"]["migration_replayed_ticks"] >= 1
    assert port["counters"]["sessions_lost_state"] == 0
    assert "w1" in port["owners"].values()
    for res in port["results"].values():
        assert [s for s, _ in res] == list(range(12))


@pytest.mark.parametrize("wire,cell", MIGRATION_CASES)
def test_graceful_leave_matches_the_reference(wire, cell):
    port, ref = _both(cell, _run_leave, wire)
    _assert_same_outcome(port, ref)
    assert set(port["owners"].values()) == {"w1"}
    assert port["counters"]["sessions_lost_state"] == 0
    for res in port["results"].values():
        assert [s for s, _ in res] == list(range(7))


@pytest.mark.parametrize("wire,cell", MIGRATION_CASES)
def test_worker_death_matches_the_reference(wire, cell):
    port, ref = _both(cell, _run_death, wire)
    assert port["victim"] == ref["victim"]
    _assert_same_outcome(port, ref)
    lost = [sid for sid, res in port["results"].items()]
    assert port["counters"]["workers_dead"] == 1
    # counted once per session the victim owned, never again
    assert 0 < port["counters"]["sessions_lost_state"] < len(lost)
    for res in port["results"].values():
        seqs = [s for s, _ in res]
        assert seqs == sorted(set(seqs)) and seqs[-1] == 4


@pytest.mark.parametrize("wire,cell", MIGRATION_CASES)
def test_router_takeover_matches_the_reference(wire, cell):
    port, ref = _both(cell, _run_takeover, wire)
    _assert_same_outcome(port, ref)
    assert port["counters"]["sessions_adopted"] == 4
    assert port["counters"]["sessions_lost_state"] == 0
    for res in port["results"].values():
        assert [s for s, _ in res] == list(range(12))


@pytest.mark.parametrize("cell", CELLS)
def test_injected_faults_match_the_reference(cell):
    port, ref = _both(cell, _run_chaos, "binary")
    _assert_same_outcome(port, ref)
    for key in ("faults", "sleeps", "bus_errors", "counted", "families"):
        assert port[key] == ref[key], key
    assert port["faults"] == [("worker.step", "kill", 2),
                              ("router.pump", "delay", 5)]
    assert port["bus_errors"] == [(r, w) for r in (2, 3)
                                  for w in ("w0", "w1")]
    assert port["sleeps"] == [0.25, 0.25]
    assert port["counted"] and port["counters"]["results_missing"] == 0
    for sid, res in port["results"].items():
        assert [s for s, _ in res] == list(range(8)), sid


@pytest.mark.parametrize("wire,cell", MIGRATION_CASES)
def test_port_migrated_run_bit_identical_to_unmigrated(wire, cell):
    """The reference's contract on the port alone: every migrated
    session's stream equals a single serial gateway's, bit for bit."""
    _, port_side = _sides(cell)
    cfg, state = port_side.model
    n_rounds = 12
    sids, norms, rows = _inputs(5, n_rounds)
    pool = SessionPool(cfg, state, capacity=8, window=WINDOW, device="cpu")
    gw = FleetGateway(pool, None, batcher_config=BatcherConfig(
        bucket_sizes=(1,), max_linger_s=0.0), pipeline_depth=0)
    ref = {sid: [] for sid in sids}
    for sid in sids:
        gw.open_session(sid, NormParams(*norms[sid]))
    for r in range(n_rounds):
        for sid in sids:
            gw.submit(sid, rows[sid][r])
            for res in gw.drain():
                ref[res.session_id].append(res.probabilities)
    out = _run_migration(port_side, wire, n_rounds)
    assert out["counters"]["migrations_completed"] >= 1
    for sid in sids:
        assert [s for s, _ in out["results"][sid]] == list(range(n_rounds))
        for r in range(n_rounds):
            np.testing.assert_array_equal(out["results"][sid][r][1],
                                          ref[sid][r], err_msg=sid)


def test_open_session_without_workers_rejects_loudly():
    _, port_side = _sides("gru")
    router, _, _, _ = _topology(port_side, [], start=False)
    with pytest.raises(NoLiveWorkers):
        router.open_session("S")
    assert router.metrics.counters["rejected_sessions"] == 1


# -- hash ring and membership -------------------------------------------------


def test_hash_session_matches_the_reference():
    ids = [f"T{i}" for i in range(200)] + ["SPY", "AAPL", "", "ñ"]
    for space in (1 << 16, 1000, 7):
        assert [port_hashring.hash_session(s, space) for s in ids] == \
            [jax_hashring.hash_session(s, space) for s in ids]


@pytest.mark.parametrize("version,workers,space", [
    (1, [], 100), (3, ["w2", "w0", "w1"], 1000), (7, ["a"], 1 << 16),
    (2, [f"w{i}" for i in range(5)], 1 << 16), (9, ["w1", "w0"], 3)])
def test_ownership_tables_match_the_reference(version, workers, space):
    port = port_hashring.OwnershipTable.derive(version, workers, space=space)
    ref = jax_hashring.OwnershipTable.derive(version, workers, space=space)
    assert port.to_wire() == ref.to_wire()
    assert port_hashring.OwnershipTable.from_wire(ref.to_wire()) == port
    for sid in (f"T{i}" for i in range(50)):
        assert port.owner_of(sid) == ref.owner_of(sid)


#: one control-topic conversation: (clock advance, message or "reap")
MEMBERSHIP_SCRIPT = [
    (0.0, {"kind": "hello", "worker": "w0", "capacity": 8}),
    (0.0, {"kind": "hello", "worker": "w1", "capacity": 8,
           "metrics": "127.0.0.1:9"}),
    (0.5, {"kind": "heartbeat", "worker": "w0",
           "stats": {"ticks_served": 5}}),
    (1.0, "reap"),
    (0.0, {"kind": "leaving", "worker": "w1"}),
    (1.5, "reap"),
    (0.0, {"kind": "heartbeat", "worker": "w0"}),
    (2.5, "reap"),
    (0.0, {"kind": "heartbeat", "worker": "w2"}),
    (0.0, {"kind": "hello", "worker": "w1"}),
    (0.0, {"kind": "goodbye", "worker": "w2", "stats": {"flushes": 3}}),
    (3.0, "reap"),
]


def _membership_verdicts(mod):
    clock = FakeClock()
    view = mod.MembershipView(timeout_s=2.0, clock=clock)
    out = []
    for dt, msg in MEMBERSHIP_SCRIPT:
        clock.advance(dt)
        if msg == "reap":
            out.append(("reap", view.reap()))
        else:
            out.append((msg["kind"], view.observe(dict(msg))))
        out.append(("live", view.live(), sorted(view.departed)))
    stats = {w: (i.stats, i.metrics, i.capacity)
             for w, i in sorted(view.workers.items())}
    return out, stats


def test_membership_verdicts_match_the_reference():
    assert _membership_verdicts(port_membership) == \
        _membership_verdicts(jax_membership)


def test_heartbeater_publishes_the_references_messages():
    def published(mod):
        sent, clock = [], FakeClock()

        class Bus:
            def publish(self, topic, value):
                sent.append((topic, value))

        hb = mod.Heartbeater(Bus(), "w0", control_topic="ctl",
                             interval_s=1.0, capacity=4, clock=clock,
                             announce={"address": "h:1"})
        hb.hello({"n": 1})
        for dt in (0.2, 0.9, 0.5, 1.0):
            clock.advance(dt)
            hb.beat({"n": 2})
        hb.goodbye({"n": 3})
        return sent

    assert published(port_membership) == published(jax_membership)


# -- the codecs: the reference's bytes ----------------------------------------


def _state_arrays(seed, n_layers=2, ring=WINDOW):
    rng = np.random.default_rng(seed)
    return {
        "carry": [[rng.normal(size=HIDDEN).astype(np.float32)
                   for _ in range(2)] for _ in range(n_layers)],
        "ring": rng.normal(size=(ring, HIDDEN)).astype(np.float32),
        "pos": 7,
        "x_min": rng.normal(size=FEATS).astype(np.float32),
        "x_range": rng.uniform(1, 3, size=FEATS).astype(np.float32),
        "seq": 11,
    }


@pytest.mark.parametrize("fmt", ["binary", "json"])
@pytest.mark.parametrize("tenant", [None, "gold"])
def test_session_state_codec_bytes_match_the_reference(fmt, tenant):
    state = _state_arrays(0)
    if tenant:
        state["tenant"] = tenant
    port = port_state.encode_session_state(state)
    ref = jax_state.encode_session_state(state)
    binary = fmt == "binary"
    assert codec.encode_payload(port, binary=binary) == \
        jax_codec.encode_payload(ref, binary=binary)
    legacy = port_state.to_legacy(port)
    assert codec.encode_payload(legacy, binary=binary) == \
        jax_codec.encode_payload(jax_state.to_legacy(ref), binary=binary)
    # each decodes the other's frame to the same arrays, bit for bit
    frame = jax_codec.encode_payload(ref, binary=binary)
    back = port_state.decode_session_state(codec.decode_payload(frame)[0])
    np.testing.assert_array_equal(back["ring"], state["ring"])
    for a, b in zip(back["carry"], state["carry"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert back.get("tenant") == tenant
    assert port_state.decode_session_state(legacy)["seq"] == 11


@pytest.mark.parametrize("fmt", ["binary", "json"])
def test_row_norm_and_param_tree_codecs_match_the_reference(fmt):
    rng = np.random.default_rng(5)
    row = rng.normal(size=FEATS).astype(np.float32)
    binary = fmt == "binary"
    enc = codec.encode_payload
    ref_enc = jax_codec.encode_payload
    assert enc(port_state.encode_row(row), binary=binary) == ref_enc(
        jax_state.encode_row(row), binary=binary)
    tick = {"kind": "tick", "session": "S", "seq": 3,
            "row": port_state.encode_row(row)}
    assert enc(port_state.legacy_tick(tick), binary=binary) == ref_enc(
        jax_state.legacy_tick(tick), binary=binary)
    norm = NormParams(row, row + 1.0)
    assert enc(port_state.encode_norm(norm), binary=binary) == ref_enc(
        jax_state.encode_norm(JaxNormParams(row, row + 1.0)), binary=binary)
    tree = {"a": {"kernel": rng.normal(size=(3, 2)).astype(np.float32)},
            "b": [np.arange(4, dtype=np.int32)]}
    assert enc(port_state.encode_param_tree(tree), binary=binary) == \
        ref_enc(jax_state.encode_param_tree(tree), binary=binary)
    decoded = port_state.decode_param_tree(
        port_state.to_legacy(port_state.encode_param_tree(tree)))
    np.testing.assert_array_equal(decoded["a"]["kernel"],
                                  tree["a"]["kernel"])
    with pytest.raises(ValueError, match="shape"):
        port_state.decode_row(port_state.encode_row(row), FEATS + 1)


def _tick_msgs(n=9, sessions=3, seed=7):
    rng = np.random.default_rng(seed)
    return [{"kind": "tick", "session": f"S{i % sessions}", "seq": i,
             "row": rng.normal(size=FEATS).astype(np.float32)}
            for i in range(n)]


Y_FIELDS = ("up1", "up2", "down1", "down2")


def _result_msgs(n=7, pool=3, seed=3):
    """A gateway flush's per-tick results (probabilities boxed as python
    floats, as the per-tick dialect publishes them)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = rng.random(len(Y_FIELDS)).astype(np.float32)
        msg = {"session": f"T{i % pool}", "seq": i,
               "probabilities": [float(v) for v in p],
               "pred_labels": [lab for lab, v in zip(Y_FIELDS, p)
                               if v >= 0.5],
               "prob_threshold": 0.5}
        if i % 2:
            msg["trace"] = f"{i:016x}:{i:016x}"
        out.append(msg)
    return out


@pytest.mark.parametrize("fmt", ["binary", "json"])
def test_tick_and_result_blocks_match_the_reference(fmt):
    binary = fmt == "binary"
    ticks = _tick_msgs()
    port_block = codec.pack_ticks(ticks)
    ref_block = jax_codec.pack_ticks(ticks)
    assert codec.encode_payload(port_block, binary=binary) == \
        jax_codec.encode_payload(ref_block, binary=binary)
    results = _result_msgs()
    port_res = codec.pack_results(results, Y_FIELDS)
    ref_res = jax_codec.pack_results(results, Y_FIELDS)
    frame = jax_codec.encode_payload(ref_res, binary=binary)
    assert codec.encode_payload(port_res, binary=binary) == frame
    # the port expands the reference's block to the same results
    expanded = list(codec.iter_results(codec.decode_payload(frame)[0]))
    ref_expanded = list(jax_codec.iter_results(ref_res))
    assert len(expanded) == len(ref_expanded) == len(results)
    for a, b in zip(expanded, ref_expanded):
        assert {k: v for k, v in a.items() if k != "probabilities"} == \
            {k: v for k, v in b.items() if k != "probabilities"}
        np.testing.assert_array_equal(
            np.asarray(a["probabilities"], np.float32),
            np.asarray(b["probabilities"], np.float32))
