"""fmda_tpu_torch's fleet runtime on the CPU: the micro-batcher, the
FleetGateway over the port's SessionPool (admission, shedding, the
one-deep pipeline, hot swaps, migration, result blocks), the load
generator and ``serve-fleet --role solo``; and the gateway against
``fmda_tpu.runtime.FleetGateway`` for gru, lstm and ssm: the same
sessions, norms and ticks under one fake clock give the same flushes, the
same counters, and probabilities within 1e-5 (float32).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fmda_tpu.config import DEFAULT_TOPICS as JAX_TOPICS
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.data.normalize import NormParams as JaxNormParams
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.runtime import BatcherConfig as JaxBatcherConfig
from fmda_tpu.runtime import FleetGateway as JaxFleetGateway
from fmda_tpu.runtime import MicroBatcher as JaxMicroBatcher
from fmda_tpu.runtime import SessionPool as JaxSessionPool
from fmda_tpu.runtime import Tick as JaxTick
from fmda_tpu.runtime.session_pool import SessionHandle as JaxHandle
from fmda_tpu.stream import InProcessBus as JaxBus

from fmda_tpu_torch.config import (
    DEFAULT_BUCKET_SIZES,
    DEFAULT_MAX_LINGER_S,
    DEFAULT_QUEUE_BOUND,
    DEFAULT_TOPICS,
    TOPIC_FLEET_PREDICTION,
    ModelConfig,
    RuntimeConfig,
    config_from_dict,
)
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.runtime import (
    BatcherConfig,
    FleetGateway,
    FleetLoadConfig,
    LatencyHistogram,
    MicroBatcher,
    PoolExhausted,
    SessionHandle,
    SessionPool,
    Tick,
    run_fleet_load,
)
from fmda_tpu_torch.stream import InProcessBus, codec

TOL = 1e-5
FEATS, HIDDEN, WINDOW = 8, 8, 6
CELLS = ["gru", "lstm", "ssm"]


def _setup(cell="gru", *, feats=FEATS, hidden=HIDDEN, seed=0):
    fields = dict(hidden_size=hidden, n_features=feats, output_size=4,
                  dropout=0.0, bidirectional=False, cell=cell)
    jax_cfg = JaxModelConfig(use_pallas=False, **fields)
    params = jax.device_get(jax_build_model(jax_cfg).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, WINDOW, feats)))["params"])
    return jax_cfg, params, ModelConfig(**fields), params_from_flax(params)


def _pool(cell="gru", capacity=4, **kw):
    _, _, cfg, state = _setup(cell, **kw)
    return SessionPool(cfg, state, capacity=capacity, window=WINDOW,
                       device="cpu")


def _gateway(cell="gru", capacity=4, buckets=(4,), linger=0.0, bus=None,
             **kw):
    return FleetGateway(
        _pool(cell, capacity), bus,
        batcher_config=BatcherConfig(bucket_sizes=buckets,
                                     max_linger_s=linger), **kw)


def _norms(n, seed=0):
    rng = np.random.default_rng(seed)
    mins = rng.normal(size=(n, FEATS)).astype(np.float32)
    maxs = mins + rng.uniform(1.0, 5.0, size=(n, FEATS)).astype(np.float32)
    return [(mins[i], maxs[i]) for i in range(n)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _row(rng):
    return rng.normal(size=FEATS).astype(np.float32)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_runtime_config_matches_the_jax_package():
    from fmda_tpu.config import DEFAULT_TOPICS as JT
    from fmda_tpu.config import RuntimeConfig as JaxRuntimeConfig
    from fmda_tpu.config import (
        DEFAULT_BUCKET_SIZES as JB, DEFAULT_MAX_LINGER_S as JL,
        DEFAULT_QUEUE_BOUND as JQ, TOPIC_FLEET_PREDICTION as JF)

    theirs = JaxRuntimeConfig()
    ours = RuntimeConfig()
    for name in ("capacity", "bucket_sizes", "max_linger_ms", "queue_bound",
                 "window", "pipeline_depth", "slo_p99_ms",
                 "predictor_bucket_sizes", "predictor_max_linger_ms",
                 "predictor_queue_bound", "predictor_window",
                 "predictor_ring"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert (DEFAULT_BUCKET_SIZES, DEFAULT_MAX_LINGER_S,
            DEFAULT_QUEUE_BOUND) == (JB, JL, JQ)
    assert TOPIC_FLEET_PREDICTION == JF and JF in DEFAULT_TOPICS
    assert set(DEFAULT_TOPICS) <= set(JT)


def test_runtime_section_is_read_and_shard_pool_accepted_unread():
    cfg = config_from_dict({"runtime": {
        "max_linger_ms": 5.0, "queue_bound": 7, "pipeline_depth": 0,
        "slo_p99_ms": 3.0, "predictor_bucket_sizes": [4, 16],
        "predictor_ring": True, "predictor_window": 12,
        "shard_pool": True}})
    rc = cfg.runtime
    assert (rc.max_linger_ms, rc.queue_bound, rc.pipeline_depth,
            rc.slo_p99_ms, rc.predictor_bucket_sizes, rc.predictor_ring,
            rc.predictor_window) == (5.0, 7, 0, 3.0, (4, 16), True, 12)
    assert not hasattr(rc, "shard_pool")
    with pytest.raises(ValueError, match="unknown keys"):
        config_from_dict({"runtime": {"max_linger": 1}})


# ---------------------------------------------------------------------------
# the bus additions
# ---------------------------------------------------------------------------


def test_bus_topics_add_topic_and_publish_many_match_the_reference():
    ours, theirs = InProcessBus(("a",), capacity=3), JaxBus(("a",),
                                                            capacity=3)
    for bus in (ours, theirs):
        bus.add_topic("b")
        bus.add_topic("a")  # idempotent: the log and offsets stay
        assert sorted(bus.topics()) == ["a", "b"]
        assert bus.publish("a", {"x": 1}) == 0
        assert bus.publish_many("a", [{"x": 2}, {"x": (3, 4)}, {"x": 5}]) \
            == [1, 2, 3]
        assert bus.publish_many("a", []) == []
        with pytest.raises(KeyError):
            bus.publish_many("zz", [{}])
    got = [(r.offset, r.value) for r in ours.read("a", 0)]
    assert got == [(r.offset, r.value) for r in theirs.read("a", 0)]
    assert got == [(1, {"x": 2}), (2, {"x": [3, 4]}), (3, {"x": 5})]


# ---------------------------------------------------------------------------
# micro-batcher: flush decisions + ordering, against the reference's
# ---------------------------------------------------------------------------


def _tick(slot, gen=0, t=0.0, seq=0, sid="s", *, jax_side=False):
    handle = (JaxHandle if jax_side else SessionHandle)(f"{sid}{slot}", slot,
                                                        gen)
    return (JaxTick if jax_side else Tick)(
        handle=handle, row=np.zeros(3, np.float32), t_enqueue=t, seq=seq)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_batcher_flushes_on_batch_full(side):
    jax_side = side == "jax"
    cls, cfg_cls = ((JaxMicroBatcher, JaxBatcherConfig) if jax_side
                    else (MicroBatcher, BatcherConfig))
    b = cls(cfg_cls(bucket_sizes=(2, 4), max_linger_s=10.0),
            clock=FakeClock())
    for slot in range(3):
        b.add(_tick(slot, jax_side=jax_side))
    assert not b.ready()
    b.add(_tick(3, jax_side=jax_side))
    assert b.ready()
    assert [t.handle.slot for t in b.take_batch()] == [0, 1, 2, 3]
    assert len(b) == 0


def test_batcher_flushes_on_deadline():
    clock = FakeClock()
    b = MicroBatcher(BatcherConfig(bucket_sizes=(8,), max_linger_s=0.005),
                     clock=clock)
    b.add(_tick(0, t=clock()))
    assert not b.ready()
    clock.advance(0.004)
    assert not b.ready()
    clock.advance(0.002)
    assert b.ready()
    assert len(b.take_batch()) == 1


def test_batcher_one_row_per_session_per_flush_as_the_reference():
    """Two rows of one session can never share a flush; per-session FIFO
    order survives the deferral — the same flushes as the reference's."""
    flushes = {}
    for jax_side in (False, True):
        b = (JaxMicroBatcher(JaxBatcherConfig(bucket_sizes=(4,),
                                              max_linger_s=0.0))
             if jax_side else
             MicroBatcher(BatcherConfig(bucket_sizes=(4,),
                                        max_linger_s=0.0)))
        for slot, seq in ((0, 0), (1, 0), (0, 1), (0, 2), (2, 0), (1, 1)):
            b.add(_tick(slot, seq=seq, jax_side=jax_side))
        assert b.distinct_sessions == 3
        out = []
        while len(b):
            out.append([(t.handle.slot, t.seq) for t in b.take_batch()])
        flushes[jax_side] = out
    assert flushes[False] == flushes[True] == [
        [(0, 0), (1, 0), (2, 0)], [(0, 1), (1, 1)], [(0, 2)]]


def test_batcher_bucket_selection_cap_and_validation():
    b = MicroBatcher(BatcherConfig(bucket_sizes=(2, 8, 32)))
    assert [b.bucket_for(n) for n in (1, 2, 3, 32)] == [2, 2, 8, 32]
    with pytest.raises(ValueError, match="largest bucket"):
        b.bucket_for(33)
    b.bucket_cap = 10
    assert b.effective_cap() == 8
    b.bucket_cap = 1
    assert b.effective_cap() == 2
    with pytest.raises(ValueError, match="ascending"):
        BatcherConfig(bucket_sizes=(8, 2))
    with pytest.raises(ValueError, match="non-empty"):
        BatcherConfig(bucket_sizes=())
    with pytest.raises(ValueError, match="max_linger_s"):
        BatcherConfig(max_linger_s=-1.0)
    assert BatcherConfig() == BatcherConfig(DEFAULT_BUCKET_SIZES,
                                            DEFAULT_MAX_LINGER_S)


def test_latency_histogram_percentiles_and_merge():
    h = LatencyHistogram()
    for ms in (1, 1, 1, 1, 1, 1, 1, 1, 1, 100):
        h.observe(ms / 1e3)
    s = h.summary()
    assert s["count"] == 10
    assert 0.8 <= s["p50_ms"] <= 1.3
    assert 80 <= s["max_ms"] <= 101 and 80 <= s["p99_ms"] <= 130
    other = LatencyHistogram()
    other.observe(0.5)
    h.merge(other)
    assert h.n == 11 and h.max_s == 0.5


# ---------------------------------------------------------------------------
# admission, shedding, stale ticks, malformed rows
# ---------------------------------------------------------------------------


def test_launch_registry_reads_and_resets_every_kernel_counter(monkeypatch):
    """Every ``*launches`` counter of an ops module is in the registry the
    gateways and the smoke read, and only those."""
    import importlib
    import pathlib

    from fmda_tpu_torch import ops

    found = set()
    for path in sorted(pathlib.Path(ops.__file__).parent.glob("[!_]*.py")):
        mod = importlib.import_module(f"{ops.__name__}.{path.stem}")
        found |= {(path.stem, name) for name, value in vars(mod).items()
                  if name.endswith("launches") and type(value) is int}
    assert found == set(ops.LAUNCH_COUNTERS.values())
    for i, (mod, attr) in enumerate(ops.LAUNCH_COUNTERS.values()):
        monkeypatch.setattr(
            importlib.import_module(f"{ops.__name__}.{mod}"), attr, i + 1)
    assert ops.launch_counts() == {
        k: i + 1 for i, k in enumerate(ops.LAUNCH_COUNTERS)}
    assert ops.total_launches() == sum(range(1, len(ops.LAUNCH_COUNTERS) + 1))
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_pinned_staging_on_the_cpu_passes_arrays_through():
    """Off a card nothing is copied: the arrays come back as tensors, and
    a tensor sent home is waited on as itself."""
    import torch

    from fmda_tpu_torch.device import PinnedStaging

    staging = PinnedStaging()
    slots = np.arange(4, dtype=np.int64)
    rows = np.random.default_rng(0).standard_normal((4, 3), np.float32)
    slots_t, rows_t = staging.to_device("flush", (slots, rows),
                                        torch.device("cpu"))
    assert slots_t.dtype == torch.int64 and rows_t.dtype == torch.float32
    np.testing.assert_array_equal(slots_t.numpy(), slots)
    np.testing.assert_array_equal(rows_t.numpy(), rows)
    back = PinnedStaging.wait(staging.to_host(rows_t, (4, 0)))
    np.testing.assert_array_equal(back, rows)


def test_small_fleet_flushes_without_linger_wait():
    clock = FakeClock()
    gw = FleetGateway(_pool(capacity=5), batcher_config=BatcherConfig(
        bucket_sizes=(8, 128), max_linger_s=99.0), clock=clock)
    for i in range(5):
        gw.open_session(f"T{i}")
    rng = np.random.default_rng(3)
    for i in range(5):
        gw.submit(f"T{i}", _row(rng))
    assert gw.pump() == []  # dispatched at once (all active pending)
    assert gw.metrics.counters["flushes_bucket_8"] == 1
    assert len(gw.pump()) == 5  # the idle pump completes it
    for i in range(3):
        gw.submit(f"T{i}", _row(rng))
    assert gw.pump() == []
    assert gw.metrics.counters["flushes"] == 1  # a partial round waits
    clock.advance(100.0)
    assert gw.pump() == []
    assert gw.metrics.counters["flushes"] == 2
    assert len(gw.pump()) == 3


def test_loadgen_respects_backpressure_beyond_queue_bound():
    gw = FleetGateway(_pool(capacity=40), batcher_config=BatcherConfig(
        bucket_sizes=(16,), max_linger_s=99.0), queue_bound=10)
    out = run_fleet_load(
        gw, FleetLoadConfig(n_sessions=40, n_ticks=3, duty=1.0, seed=0))
    assert out["ticks_submitted"] == out["ticks_served"] == 120
    assert out["counters"].get("shed_oldest", 0) == 0


def test_overload_sheds_oldest_with_counters():
    clock = FakeClock()
    gw = _gateway(queue_bound=6, linger=99.0, clock=clock)
    for i in range(4):
        gw.open_session(f"T{i}")
    rng = np.random.default_rng(1)
    for k in range(20):
        gw.submit(f"T{k % 4}", _row(rng))
    assert len(gw.batcher) == 6 and gw.saturated
    assert gw.metrics.counters["shed_oldest"] == 14
    assert gw.metrics.gauges["queue_depth_peak"] == 6
    res = gw.drain()
    assert sorted((r.session_id, r.seq) for r in res) == [
        ("T0", 4), ("T1", 4), ("T2", 3), ("T2", 4), ("T3", 3), ("T3", 4)]
    assert gw.metrics.counters["ticks_served"] == 6
    assert len(gw.batcher) == 0 and not gw.saturated


def test_session_close_drops_queued_ticks_visibly():
    gw = _gateway(capacity=2, buckets=(2,), linger=99.0)
    gw.open_session("a")
    gw.open_session("b")
    gw.submit("a", np.zeros(FEATS, np.float32))
    gw.submit("b", np.zeros(FEATS, np.float32))
    gw.close_session("a")
    res = gw.drain()
    assert [r.session_id for r in res] == ["b"]
    assert gw.metrics.counters["stale_dropped"] == 1
    with pytest.raises(KeyError):
        gw.submit("a", np.zeros(FEATS, np.float32))
    with pytest.raises(KeyError):
        gw.close_session("a")


def test_close_between_dispatch_and_completion_drops_the_result():
    """The persistent pipeline lets a close (and a same-id reopen, which
    restarts seq at 0) land while the session's flush is in flight: its
    result is dropped and counted, never published into the new stream."""
    bus = InProcessBus(DEFAULT_TOPICS)
    gw = _gateway(capacity=2, buckets=(2,), linger=0.0, bus=bus)
    gw.open_session("a")
    gw.open_session("b")
    rng = np.random.default_rng(2)
    gw.submit("a", _row(rng))
    gw.submit("b", _row(rng))
    assert gw.pump() == []  # in flight
    gw.close_session("a")
    gw.open_session("a")
    res = gw.pump()
    assert [r.session_id for r in res] == ["b"]
    assert gw.metrics.counters["stale_results_dropped"] == 1
    assert gw.session_seq("a") == 0


def test_submit_copies_caller_row_buffer():
    pool = _pool(capacity=1)
    gw = FleetGateway(pool, batcher_config=BatcherConfig(
        bucket_sizes=(1,), max_linger_s=99.0))
    gw.open_session("a")
    _, _, cfg, state = _setup()
    ref_pool = SessionPool(cfg, state, capacity=1, window=WINDOW,
                           device="cpu")
    h = ref_pool.alloc("a")
    row = np.random.default_rng(0).normal(size=FEATS).astype(np.float32)
    want = ref_pool.step([h.slot], row[None])[0]
    gw.submit("a", row)
    row[:] = 1e6  # the caller reuses its buffer while the tick is queued
    np.testing.assert_array_equal(gw.drain()[0].probabilities, want)


def test_submit_rejects_malformed_row_at_the_submitter():
    gw = _gateway(capacity=2, buckets=(2,), linger=99.0)
    gw.open_session("good")
    gw.open_session("bad")
    gw.submit("good", np.zeros(FEATS, np.float32))
    with pytest.raises(ValueError, match="row shape"):
        gw.submit("bad", np.zeros(FEATS + 2, np.float32))
    assert [r.session_id for r in gw.drain()] == ["good"]


def test_gateway_refuses_bad_construction():
    pool = _pool(capacity=1)
    with pytest.raises(ValueError, match="fleet_prediction"):
        FleetGateway(pool, InProcessBus(("prediction",)))
    with pytest.raises(ValueError, match="pipeline_depth"):
        FleetGateway(pool, pipeline_depth=2)
    with pytest.raises(ValueError, match="queue_bound"):
        FleetGateway(pool, queue_bound=0)


def test_admission_rejection_is_counted():
    gw = FleetGateway(_pool(capacity=1))
    gw.open_session("a")
    with pytest.raises(PoolExhausted):
        gw.open_session("b")
    with pytest.raises(ValueError, match="already allocated"):
        gw.open_session("a")
    assert gw.metrics.counters["rejected_sessions"] == 1
    assert gw.metrics.gauges["active_sessions"] == 1


# ---------------------------------------------------------------------------
# the numerical contract and the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_bucket1_gateway_bit_identical_to_the_pools_own_step(cell):
    """The multiplexing machinery (slot gather and scatter, per-slot
    positions, interleaving with other sessions' flushes, the staging and
    the copy home) adds nothing: at bucket 1 every result is the port's
    own SessionPool.step on the same rows, bit for bit."""
    n = 3
    gw = _gateway(cell, capacity=n, buckets=(1,))
    _, _, cfg, state = _setup(cell)
    solo = SessionPool(cfg, state, capacity=n, window=WINDOW, device="cpu")
    norms = _norms(n)
    handles = []
    for i in range(n):
        gw.open_session(f"T{i}", NormParams(*norms[i]))
        handles.append(solo.alloc(f"T{i}", NormParams(*norms[i])))
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(6, n, FEATS)).astype(np.float32)
    for k in range(6):
        for i in range(n):
            gw.submit(f"T{i}", rows[k, i])
        by_sid = {r.session_id: r.probabilities for r in gw.drain()}
        for i in range(n):
            np.testing.assert_array_equal(
                by_sid[f"T{i}"],
                solo.step([handles[i].slot], rows[k, i][None])[0])
    assert gw.kernel_launches_by_bucket == {1: 0}


@pytest.mark.parametrize("cell", CELLS)
def test_overlap_pipeline_bit_identical_to_serial(cell):
    n = 10
    norms = _norms(n, seed=9)
    gws = []
    for depth in (0, 1):
        gw = _gateway(cell, capacity=n, buckets=(4,),
                      bus=InProcessBus(DEFAULT_TOPICS), pipeline_depth=depth)
        for i in range(n):
            gw.open_session(f"T{i}", NormParams(*norms[i]))
        gws.append(gw)
    rng = np.random.default_rng(10)
    for _ in range(6):
        ticking = np.flatnonzero(rng.random(n) < 0.8)
        rows = rng.normal(size=(n, FEATS)).astype(np.float32)
        outs = []
        for gw in gws:
            for i in ticking:
                gw.submit(f"T{i}", rows[i])
            outs.append(gw.drain())
        serial, overlapped = outs
        assert [(r.session_id, r.seq) for r in serial] == \
            [(r.session_id, r.seq) for r in overlapped]
        for a, b in zip(serial, overlapped):
            np.testing.assert_array_equal(a.probabilities, b.probabilities)
            assert a.labels == b.labels
    assert gws[1].metrics.counters["overlapped_flushes"] > 0
    assert gws[0].metrics.counters.get("overlapped_flushes", 0) == 0
    msgs = [gw.bus.consumer(TOPIC_FLEET_PREDICTION).poll() for gw in gws]
    assert [m.value for m in msgs[0]] == [m.value for m in msgs[1]]


def test_pump_failure_never_strands_the_inflight_flush():
    class FailOnceBus(InProcessBus):
        def __init__(self, topics):
            super().__init__(topics)
            self.failed = False

        def publish_many(self, topic, values):
            if not self.failed:
                self.failed = True
                raise RuntimeError("transport hiccup")
            return super().publish_many(topic, values)

    n = 4
    bus = FailOnceBus(DEFAULT_TOPICS)
    gw = _gateway(capacity=n, buckets=(2,), bus=bus)
    for i in range(n):
        gw.open_session(f"T{i}")
    rng = np.random.default_rng(15)
    for i in range(n):
        gw.submit(f"T{i}", _row(rng))
    with pytest.raises(RuntimeError, match="transport hiccup"):
        gw.drain()
    assert gw.metrics.counters["flush_results_lost"] == 2
    assert gw.metrics.counters["publish_errors"] == 1
    assert gw.metrics.counters["ticks_served"] == 2
    assert [m.value["session"] for m in
            bus.consumer(TOPIC_FLEET_PREDICTION).poll()] == ["T2", "T3"]
    for i in range(n):
        gw.submit(f"T{i}", _row(rng))
    assert sorted((r.session_id, r.seq) for r in gw.drain()) == [
        (f"T{i}", 1) for i in range(n)]


def test_generation_guard_rejects_stale_mid_pipeline():
    n = 6
    gw = _gateway(capacity=n, buckets=(2,))
    _, _, cfg, state = _setup()
    solo = SessionPool(cfg, state, capacity=n, window=WINDOW, device="cpu")
    handles = {}
    for i in range(n):
        gw.open_session(f"T{i}")
        handles[f"T{i}"] = solo.alloc(f"T{i}")
    rng = np.random.default_rng(11)
    rows = rng.normal(size=(2, n, FEATS)).astype(np.float32)
    for k in range(2):
        for i in range(n):
            gw.submit(f"T{i}", rows[k, i])
    gw.close_session("T3")  # both queued ticks now stale
    res = gw.drain()
    assert gw.metrics.counters["stale_dropped"] == 2
    by_key = {(r.session_id, r.seq): r.probabilities for r in res}
    assert len(by_key) == 2 * (n - 1) and ("T3", 0) not in by_key
    for i in range(n):
        if i == 3:
            continue
        for k in range(2):
            np.testing.assert_allclose(
                by_key[(f"T{i}", k)],
                solo.step([handles[f"T{i}"].slot], rows[k, i][None])[0],
                atol=1e-6)


# ---------------------------------------------------------------------------
# hot swap, migration, retune, QoS seam
# ---------------------------------------------------------------------------


def test_hot_swap_barrier_completes_the_inflight_flush_first():
    """The in-flight flush publishes under the old weights (no version
    stamp), everything after the swap under the new version, and the
    barrier's results reach the caller on the next pump."""
    _, _, cfg, old_state = _setup(seed=0)
    _, _, _, new_state = _setup(seed=1)
    bus = InProcessBus(DEFAULT_TOPICS)
    gw = FleetGateway(
        SessionPool(cfg, old_state, capacity=2, window=WINDOW, device="cpu"),
        bus, batcher_config=BatcherConfig(bucket_sizes=(2,),
                                          max_linger_s=0.0))
    ref = SessionPool(cfg, old_state, capacity=2, window=WINDOW, device="cpu")
    ha, hb = ref.alloc("a"), ref.alloc("b")
    gw.open_session("a")
    gw.open_session("b")
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(2, 2, FEATS)).astype(np.float32)
    gw.submit("a", rows[0, 0])
    gw.submit("b", rows[0, 1])
    assert gw.pump() == []  # in flight under the old weights
    assert gw.hot_swap(new_state) == 1
    want_old = ref.step([ha.slot, hb.slot], rows[0])
    ref.swap_weights(new_state)
    gw.submit("a", rows[1, 0])
    gw.submit("b", rows[1, 1])
    res = gw.drain()
    assert [(r.seq, r.weights_version) for r in res] == [
        (0, None), (0, None), (1, 1), (1, 1)]
    np.testing.assert_array_equal(res[0].probabilities, want_old[0])
    np.testing.assert_array_equal(
        res[2].probabilities, ref.step([ha.slot, hb.slot], rows[1])[0])
    msgs = [m.value for m in bus.consumer(TOPIC_FLEET_PREDICTION).poll()]
    assert ["weights_version" in m for m in msgs] == [False, False, True,
                                                      True]
    assert gw.version_ticks == {0: 2, 1: 2}
    assert gw.metrics.counters["hot_swaps_applied"] == 1
    assert gw.hot_swap(old_state, version=7) == 7


def test_export_import_session_continues_the_stream_bit_exactly():
    src = _gateway("ssm", capacity=2, buckets=(1,))
    dst = _gateway("ssm", capacity=3, buckets=(1,))
    dst.open_session("other")
    norm = NormParams(*_norms(1)[0])
    src.open_session("m", norm, tenant="gold")
    rng = np.random.default_rng(5)
    for _ in range(4):
        src.submit("m", _row(rng))
    src.drain()
    state = src.export_session("m")
    assert state["seq"] == 4 and state["tenant"] == "gold"
    dst.import_session("m", state)
    assert dst.session_seq("m") == 4 and dst.session_tenant("m") == "gold"
    row = _row(rng)
    src.submit("m", row)
    dst.submit("m", row)
    a, b = src.drain()[0], dst.drain()[0]
    assert a.seq == b.seq == 4
    np.testing.assert_array_equal(a.probabilities, b.probabilities)
    dst.resync_seq("m", 10)
    assert dst.session_seq("m") == 10
    bad = dict(state, carry=[])
    with pytest.raises(ValueError, match="carry layers"):
        dst.import_session("n", bad)
    assert dst.pool.handle_for("n") is None  # the slot was not leaked
    for fn in (dst.export_session, dst.session_seq):
        with pytest.raises(KeyError):
            fn("zz")


def test_retune_swaps_linger_and_caps_the_bucket():
    clock = FakeClock()
    gw = FleetGateway(_pool(capacity=8), batcher_config=BatcherConfig(
        bucket_sizes=(2, 8), max_linger_s=99.0), clock=clock)
    for i in range(8):
        gw.open_session(f"T{i}")
    gw.retune(max_linger_ms=1.0, bucket_cap=3)
    assert gw.batcher.config.max_linger_s == 1e-3
    rng = np.random.default_rng(0)
    for i in range(5):
        gw.submit(f"T{i}", _row(rng))
    clock.advance(0.002)
    gw.drain()
    c = gw.metrics.counters
    assert c["flushes_bucket_2"] == 3 and c.get("flushes_bucket_8", 0) == 0
    assert c["retunes_applied"] == 1


def test_attached_qos_policy_sheds_by_class():
    class Policy:
        def classify(self, tenant):
            return tenant or "standard"

        def quota(self, cls, bound):
            return 2 if cls == "bulk" else bound

        def pick_victim(self, queued):
            return "bulk" if queued.get("bulk") else None

    gw = _gateway(capacity=4, queue_bound=4, linger=99.0)
    gw.attach_qos(Policy())
    gw.open_session("g", tenant="gold")
    for i in range(3):
        gw.open_session(f"b{i}", tenant="bulk")
    rng = np.random.default_rng(0)
    for i in range(3):
        gw.submit(f"b{i}", _row(rng))  # the third sheds bulk's oldest
    gw.submit("g", _row(rng))
    gw.submit("g", _row(rng))
    gw.submit("g", _row(rng))  # queue full: bulk is the victim
    c = gw.metrics.counters
    assert c["quota_shed"] == 1 and c["shed_oldest"] == 1
    assert c["shed_class_bulk"] == 2 and c["admitted_class_gold"] == 3
    assert sorted((r.session_id, r.seq) for r in gw.drain()) == [
        ("b2", 0), ("g", 0), ("g", 1), ("g", 2)]
    gw.attach_qos(None)
    assert gw.qos is None


# ---------------------------------------------------------------------------
# against the JAX package's FleetGateway
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_gateway_matches_the_jax_gateway(cell):
    """The same sessions (per-session norms), the same ragged ticks, a
    reconnect storm and an overload burst, both gateways on one fake
    clock: the same flushes (buckets, padding, sheds, stale drops), the
    same (session, seq, labels) on the bus in the same order, and
    probabilities within 1e-5."""
    jax_cfg, params, cfg, state = _setup(cell)
    n = 8
    jax_clock, clock = FakeClock(), FakeClock()
    kw = dict(queue_bound=12)
    jax_gw = JaxFleetGateway(
        JaxSessionPool(jax_cfg, params, capacity=n, window=WINDOW),
        JaxBus(JAX_TOPICS), batcher_config=JaxBatcherConfig(
            bucket_sizes=(2, 4, 8), max_linger_s=0.005),
        clock=jax_clock, **kw)
    gw = FleetGateway(
        SessionPool(cfg, state, capacity=n, window=WINDOW, device="cpu"),
        InProcessBus(DEFAULT_TOPICS), batcher_config=BatcherConfig(
            bucket_sizes=(2, 4, 8), max_linger_s=0.005), clock=clock, **kw)
    norms = _norms(n, seed=12)
    for i in range(n):
        jax_gw.open_session(f"T{i}", JaxNormParams(*norms[i]))
        gw.open_session(f"T{i}", NormParams(*norms[i]))
    rng = np.random.default_rng(13)
    for r in range(14):
        if r == 6:  # reconnect storm: two sessions close with a tick
            # queued and reopen
            for i in (1, 5):
                row = rng.normal(size=FEATS).astype(np.float32)
                for g, nrm in ((jax_gw, JaxNormParams), (gw, NormParams)):
                    g.submit(f"T{i}", row)
                    g.close_session(f"T{i}")
                    g.open_session(f"T{i}", nrm(*norms[i]))
        # an overload burst: every session ticks twice, unpumped
        reps = 2 if r == 9 else 1
        for _ in range(reps):
            ticking = np.flatnonzero(rng.random(n) < 0.6) if reps == 1 \
                else np.arange(n)
            rows = rng.normal(size=(n, FEATS)).astype(np.float32)
            for i in ticking:
                assert (jax_gw.submit(f"T{i}", rows[i])
                        == gw.submit(f"T{i}", rows[i]))
        for c in (jax_clock, clock):
            c.advance(0.003)
        jax_gw.pump()
        gw.pump()
    jax_gw.drain()
    gw.drain()
    theirs = [m.value for m in jax_gw.bus.consumer(
        TOPIC_FLEET_PREDICTION).poll()]
    ours = [m.value for m in gw.bus.consumer(TOPIC_FLEET_PREDICTION).poll()]
    assert len(ours) == len(theirs) > 50
    for a, b in zip(ours, theirs):
        assert (a["session"], a["seq"], a["pred_labels"]) == (
            b["session"], b["seq"], b["pred_labels"])
        np.testing.assert_allclose(a["probabilities"], b["probabilities"],
                                   atol=TOL)
    keys = {k for k in jax_gw.metrics.counters
            if k.startswith("flushes_bucket_")} | {
        "flushes", "padded_lanes", "shed_oldest", "stale_dropped",
        "stale_results_dropped", "ticks_served", "overlapped_flushes"}
    for k in sorted(keys):
        assert gw.metrics.counters.get(k) == jax_gw.metrics.counters.get(k), k
    assert gw.metrics.counters["shed_oldest"] > 0
    assert gw.metrics.counters["stale_dropped"] > 0


# ---------------------------------------------------------------------------
# load generator, result blocks, CLI
# ---------------------------------------------------------------------------


def test_run_fleet_load_end_to_end():
    gw = FleetGateway(_pool("ssm", capacity=16), batcher_config=BatcherConfig(
        bucket_sizes=(16,), max_linger_s=0.0))
    out = run_fleet_load(
        gw, FleetLoadConfig(n_sessions=16, n_ticks=5, duty=0.8, seed=0))
    assert out["ticks_served"] == out["ticks_submitted"] > 0
    assert out["kernel_launches_by_bucket"] == {"16": 0}  # the CPU
    assert out["latency"]["total"]["count"] == out["ticks_served"]
    assert set(out["latency"]) >= {"enqueue_to_dispatch", "device", "total"}
    assert out["ticks_per_s"] > 0
    assert set(out["host_stages"]) >= {"dispatch", "device", "publish"}


def test_run_fleet_load_shapes_match_the_reference():
    """The load generator draws what the reference's draws: the same
    submissions, storms, bursts and stragglers from one seed."""
    from fmda_tpu.runtime import FleetLoadConfig as JaxLoad
    from fmda_tpu.runtime import run_fleet_load as jax_run

    jax_cfg, params, cfg, state = _setup()
    fields = dict(n_sessions=12, n_ticks=8, duty=0.6, seed=3, storm_every=3,
                  burst_every=4, slow_fraction=0.25,
                  tenant_classes=("gold", "std"), tenant_weights=(1, 3))
    jax_gw = JaxFleetGateway(
        JaxSessionPool(jax_cfg, params, capacity=12, window=WINDOW),
        batcher_config=JaxBatcherConfig(bucket_sizes=(16,),
                                        max_linger_s=0.0))
    gw = FleetGateway(
        SessionPool(cfg, state, capacity=12, window=WINDOW, device="cpu"),
        batcher_config=BatcherConfig(bucket_sizes=(16,), max_linger_s=0.0))
    theirs = jax_run(jax_gw, JaxLoad(**fields))
    ours = run_fleet_load(gw, FleetLoadConfig(**fields))
    for k in ("ticks_submitted", "ticks_served", "sessions_reopened",
              "burst_ticks", "slow_sessions", "submitted_by_class"):
        assert ours[k] == theirs[k], k
    assert ours["counters"] == theirs["counters"]


def _result_blocks_run(result_blocks):
    bus = InProcessBus(DEFAULT_TOPICS)
    gw = _gateway(capacity=4, buckets=(4,), bus=bus)
    gw.result_blocks = result_blocks
    rng = np.random.default_rng(7)
    sids = [f"T{i}" for i in range(4)]
    for sid in sids:
        mn = rng.normal(size=FEATS).astype(np.float32)
        gw.open_session(sid, NormParams(mn, mn + 1.0))
    for _ in range(5):
        for sid in sids:
            gw.submit(sid, _row(rng), wire=f"{sid}:w")
        gw.pump(force=True)
    gw.drain()
    flat = []
    for rec in bus.consumer(TOPIC_FLEET_PREDICTION).poll():
        v = rec.value
        flat.extend(codec.iter_results(v) if v.get("kind") == "result_block"
                    else [v])
    return flat


def test_result_block_dialect_bit_identical_to_per_tick():
    per_tick, blocked = _result_blocks_run(False), _result_blocks_run(True)
    assert len(per_tick) == len(blocked) == 20
    for a, b in zip(per_tick, blocked):
        assert (a["session"], a["seq"], a["trace"]) == (
            b["session"], b["seq"], b["trace"])
        assert a["pred_labels"] == list(b["pred_labels"])
        assert a["prob_threshold"] == b["prob_threshold"]
        assert np.array_equal(np.asarray(a["probabilities"], np.float32),
                              np.asarray(b["probabilities"], np.float32))


def test_unpackable_result_run_degrades_to_per_tick_counted():
    bus = InProcessBus(DEFAULT_TOPICS)
    gw = _gateway(capacity=4, buckets=(4,), bus=bus,
                  y_fields=tuple(f"lab{i}" for i in range(70)))
    gw.result_blocks = True
    rng = np.random.default_rng(0)
    for i in range(3):
        gw.open_session(f"T{i}")
    for i in range(3):
        gw.submit(f"T{i}", _row(rng))
    assert len(gw.pump(force=True)) == 3
    assert gw.metrics.counters["result_pack_errors"] == 1
    records = bus.consumer(TOPIC_FLEET_PREDICTION).poll()
    assert len(records) == 3
    assert all(r.value.get("kind") is None for r in records)


FLEET_ARGS = ["serve-fleet", "--hidden", "4", "--window", "3",
              "--seed", "0", "--device", "cpu"]


def test_serve_fleet_cli(capsys):
    from fmda_tpu_torch.__main__ import main

    assert main(FLEET_ARGS + ["--sessions", "8", "--ticks", "4",
                              "--bucket-sizes", "8", "--cell", "ssm"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["sessions"] == 8 and out["cell"] == "ssm"
    assert out["ticks_served"] == out["ticks_submitted"] == 32
    assert out["kernel_launches_by_bucket"] == {"8": 0}
    assert out["counters"]["ticks_served"] == 32
    assert out["device"] == "cpu"
    assert {"latency", "counters", "gauges", "host_stages"} <= set(out)


def test_serve_fleet_cli_slo_gate(capsys):
    from fmda_tpu_torch.__main__ import main

    args = FLEET_ARGS + ["--sessions", "4", "--ticks", "2",
                         "--bucket-sizes", "4"]
    assert main(args + ["--slo-p99-ms", "1e9"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["slo"]["ok"] is True and out["slo"]["p99_ms_bound"] == 1e9
    assert main(args + ["--slo-p99-ms", "1e-9"]) == 1
    assert json.loads(capsys.readouterr().out)["slo"]["ok"] is False
    assert main(args + ["--slo-p99-ms", "1e-9", "--slo-soft"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["slo"] == {"p99_ms_bound": 1e-9, "p99_ms": out["slo"]["p99_ms"],
                          "ok": False, "soft": True}


def test_serve_fleet_cli_serial_matches_default(capsys):
    from fmda_tpu_torch.__main__ import main

    outs = []
    for extra in ([], ["--serial"]):
        assert main(FLEET_ARGS + ["--sessions", "6", "--ticks", "3",
                                  "--bucket-sizes", "2"] + extra) == 0
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0]["ticks_served"] == outs[1]["ticks_served"] == 18
    assert outs[0]["counters"].get("overlapped_flushes", 0) > 0
    assert outs[1]["counters"].get("overlapped_flushes", 0) == 0


@pytest.mark.parametrize("extra,item", [
    # the multi-host roles, the control plane, QoS and the fleet soak run
    # (tests/test_torch_multihost.py, tests/test_torch_control.py); what
    # stays refused is the sharded pool (8)
    (["--shard-pool"], "item 8"),
])
def test_serve_fleet_refuses_unported_planes(capsys, extra, item):
    from fmda_tpu_torch.__main__ import main

    assert main(FLEET_ARGS + extra) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and f"ROADMAP queue 1, {item}" in err


def test_serve_fleet_continuous_train_swaps_into_the_live_gateway(
        tmp_path, capsys):
    """``--continuous-train``: 14 days of bars (1,092 rows) tailed in pages
    of 1,024 beside the load, two rounds, each swapped into the gateway."""
    from fmda_tpu_torch.__main__ import main

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"train": {
        "window": 6, "chunk_size": 100, "batch_size": 64,
        "continuous_poll_s": 0.01}}))
    ckpt_dir = tmp_path / "ckpt"
    assert main(FLEET_ARGS + [
        "--config", str(cfg), "--sessions", "4", "--ticks", "5",
        "--continuous-train", "--continuous-days", "14", "--train-rounds",
        "2", "--train-checkpoint-dir", str(ckpt_dir)]) == 0
    out = json.loads(capsys.readouterr().out)
    ct = out["continuous_train"]
    assert ct["rounds"] == 2 and ct["rows_seen"] == 14 * 78
    assert ct["swaps_accepted"] == ct["weights_version"] == 2
    assert ct["swaps_refused"] == 0
    assert "trainer_unexpected_recompiles" not in ct
    assert [os.path.dirname(c) for c in ct["checkpoints"]] == \
        [str(ckpt_dir)] * 2
    assert all(os.path.exists(c) for c in ct["checkpoints"])
    assert out["ticks_served"] == out["ticks_submitted"] == 20


def test_serve_fleet_swap_guard_waits_on_the_shadow_evaluator(capsys):
    """``--swap-guard`` gates each continuous round on the shadow
    evaluator; without ``--continuous-train`` it exits 2 with the
    reference's own message, as do the other refused combinations."""
    from fmda_tpu_torch.__main__ import main

    for extra, said in (
            (["--swap-guard"], "add --continuous-train"),
            (["--hot-swap"], "it needs --replay"),
            (["--replay", "--predictor"], "not --predictor"),
            (["--continuous-train", "--replay"], "drop --replay/--predictor"),
            (["--continuous-train", "--predictor"],
             "drop --replay/--predictor")):
        assert main(FLEET_ARGS + extra) == 2
        err = capsys.readouterr().err
        assert said in err and "not ported yet" not in err
