"""fmda_tpu_torch's continuous fine-tuning on the CPU: the warehouse's
tail-follow reader against ``fmda_tpu``'s on the same landed rows, the
sliding ``TailSource``, the loop into the port's ``FleetGateway`` (rounds,
checkpoints and drift profiles, the served weights, a skipped round, a
refused swap), the loop's final params against ``fmda_tpu``'s
``ContinuousTrainer`` from the same initial params, and hot swaps from
another thread than the pumping one.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.config import TrainConfig as JaxTrainConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.stream import Warehouse as JaxWarehouse
from fmda_tpu.train import ContinuousTrainer as JaxContinuousTrainer

from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    TOPIC_FLEET_PREDICTION,
    FeatureConfig,
    ModelConfig,
    TrainConfig,
    WarehouseConfig,
)
from fmda_tpu_torch.data import ArraySource
from fmda_tpu_torch.data.synthetic import random_walk_rows
from fmda_tpu_torch.eval import load_profile, profile_path_for
from fmda_tpu_torch.interop import params_from_flax
from fmda_tpu_torch.models import build_model
from fmda_tpu_torch.runtime import BatcherConfig, FleetGateway, SessionPool
from fmda_tpu_torch.stream import InProcessBus, Warehouse
from fmda_tpu_torch.train import (
    ContinuousTrainer,
    TailSource,
    gateway_publisher,
    restore_checkpoint,
    router_publisher,
)

#: a narrow schema: 2-level book, one economic event, no COT feed
FEATURES = dict(get_cot=False, bid_levels=2, ask_levels=2,
                event_list=("Core CPI",))
HIDDEN = 8
#: the loop's knobs at a small size: a round every 40 fresh rows over the
#: newest 160, chunks of 40 rows and windows of 4, no holdout
LOOP = dict(batch_size=16, window=4, chunk_size=40, val_size=0.0,
            test_size=0.0, continuous_min_rows=40,
            continuous_window_rows=160, continuous_follow_polls=2)
#: tail page size
PAGE = 64
#: the two loops after two rounds (~20 Adam steps) from the same params
PARAM_TOL = 1e-4


def _rows(n, seed=0):
    return random_walk_rows(FeatureConfig(**FEATURES).table_columns(), n,
                            seed=seed)


def _port_warehouse(path=":memory:"):
    return Warehouse(FeatureConfig(**FEATURES), WarehouseConfig(path=path))


def _jax_warehouse():
    return JaxWarehouse(JaxFeatureConfig(**FEATURES),
                        JaxWarehouseConfig(path=":memory:"))


def _lander(wh, batches, *, also=None):
    """A waiter that lands the next batch of rows on each call (and runs
    ``also``); nothing once they are spent."""
    pending = list(batches)

    def wait():
        if pending:
            wh.insert_rows(pending.pop(0))
        if also is not None:
            also()

    return wait


# ---------------------------------------------------------------------------
# the tail reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("follow", [0, 3])
def test_iter_row_chunks_matches_the_jax_warehouse(follow):
    """The same landed rows, the same rows landed between polls: the same
    chunks, bit for bit, and with ``follow`` every row exactly once."""
    rows = _rows(300, seed=1)
    first, later = rows[:130], [rows[130:200], rows[200:300]]
    runs = []
    for wh in (_port_warehouse(), _jax_warehouse()):
        wh.insert_rows(first)
        runs.append(list(wh.iter_row_chunks(
            chunk=50, follow=follow, poll_wait=_lander(wh, later))))
    got, want = runs
    assert len(got) == len(want) > 0
    for (g_ts, g), (w_ts, w) in zip(got, want):
        assert g_ts == w_ts
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    stamps = [ts for chunk_ts, _ in got for ts in chunk_ts]
    expect = rows if follow else first
    assert stamps == [r["Timestamp"] for r in expect]


def test_iter_row_chunks_bounds_and_arguments_match_the_jax_warehouse():
    rows = _rows(120, seed=2)
    port, ref = _port_warehouse(), _jax_warehouse()
    for wh in (port, ref):
        wh.insert_rows(rows)
    lo, hi = rows[17]["Timestamp"], rows[88]["Timestamp"]
    for kw in (dict(start_ts=lo), dict(end_ts=hi),
               dict(start_ts=lo, end_ts=hi, chunk=7), dict(chunk=120)):
        got = list(port.iter_row_chunks(**kw))
        want = list(ref.iter_row_chunks(**kw))
        assert [ts for ts, _ in got] == [ts for ts, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        next(port.iter_row_chunks(chunk=0))
    waits = []
    assert list(_port_warehouse().iter_row_chunks(
        follow=2, poll_wait=lambda: waits.append(1))) == []
    assert len(waits) == 2  # two empty polls end an empty tail


def test_tail_source_is_the_newest_rows_of_its_base():
    r = np.random.default_rng(3)
    x = r.normal(size=(50, 5)).astype(np.float32)
    y = (r.random((50, 4)) < 0.5).astype(np.float32)
    base = ArraySource(x, y, [f"f{i}" for i in range(5)])
    tail = TailSource(base, 30, 20)
    assert len(tail) == 20 and tail.x_fields == base.x_fields
    np.testing.assert_array_equal(tail.fetch(range(1, 21)), x[30:])
    np.testing.assert_array_equal(tail.fetch_targets([1, 20]), y[[30, 49]])
    with pytest.raises(IndexError):
        tail.fetch([21])


# ---------------------------------------------------------------------------
# the loop into a FleetGateway
# ---------------------------------------------------------------------------


def _serving(n_features):
    model_cfg = ModelConfig(hidden_size=HIDDEN, n_features=n_features,
                            dropout=0.0, bidirectional=False, cell="gru")
    params = build_model(
        model_cfg, generator=torch.Generator().manual_seed(7)).state_dict()
    pool = SessionPool(model_cfg, params, capacity=4, window=6, device="cpu")
    gateway = FleetGateway(
        pool, InProcessBus(DEFAULT_TOPICS),
        batcher_config=BatcherConfig(bucket_sizes=(4,), max_linger_s=0.0))
    return model_cfg, gateway


def _serve_round(gateway, wh, served):
    """Every session ticks on the newest row, then a pump."""
    row = wh.fetch([len(wh)])[0]
    for i in range(2):
        gateway.submit(f"S{i}", row)
    served.extend(gateway.pump())


def _loop(tmp_path, *, require_eval=None, landed=40, batches=3):
    wh = _port_warehouse()
    rows = _rows(landed + 50 * batches, seed=4)
    wh.insert_rows(rows[:landed])
    model_cfg, gateway = _serving(len(wh.x_fields))
    for i in range(2):
        gateway.open_session(f"S{i}")
    served = []
    later = [rows[landed + 50 * k:landed + 50 * (k + 1)]
             for k in range(batches)]
    ct = ContinuousTrainer(
        wh, model_cfg, TrainConfig(**LOOP),
        checkpoint_dir=str(tmp_path / "ckpt"),
        publish=gateway_publisher(gateway, require_eval=require_eval),
        drift_bins=8, target_lead=FeatureConfig(**FEATURES).max_lead,
        wait_fn=_lander(wh, later,
                        also=lambda: _serve_round(gateway, wh, served)),
        chunk=PAGE, device="cpu")
    return ct, gateway, wh, served


def test_the_loop_trains_checkpoints_and_swaps_into_the_gateway(
        tmp_path, caplog):
    """40 rows first (fresh enough for a round, too few for a chunk plus
    a window: that round is skipped), then
    three landings of 50: three rounds, each checkpointed with its drift
    profile and swapped into the live gateway, which serves on between
    them; the pool ends serving the last round's weights, bit for bit."""
    caplog.set_level("INFO", logger="fmda_tpu_torch.train.continuous")
    ct, gateway, wh, served = _loop(tmp_path)
    out = ct.run()
    assert "round skipped: window has 40 rows" in caplog.text
    assert out["rounds"] == 3 and out["rows_seen"] == 190
    assert out["swaps_accepted"] == 3 and out["swaps_refused"] == 0
    assert "trainer_unexpected_recompiles" not in out
    assert gateway.weights_version == 3
    assert len(out["checkpoints"]) == 3
    for ckpt in out["checkpoints"]:
        profile = load_profile(profile_path_for(ckpt))
        assert profile["n_features"] == len(wh.x_fields)
        assert profile["bins"] == 8 and len(profile["label_rates"]) == 4
    steps = [restore_checkpoint(c)[0]["step"] for c in out["checkpoints"]]
    assert steps == sorted(set(steps)) and steps[-1] == ct.state.step
    served_params = gateway.pool.live_tree()[0]
    trained = ct.state.model.state_dict()
    assert served_params.keys() == trained.keys()
    for name, p in trained.items():
        assert torch.equal(served_params[name], p), name
    # served under more than one version while the loop ran
    assert len(gateway.version_ticks) >= 2
    assert {r.weights_version for r in served} >= {None, 1}


def test_a_refused_round_keeps_the_accepted_weights_serving(tmp_path):
    """Round 1 accepted, round 2 refused: the pool serves round 1's
    weights bit for bit, though the trainer's own params moved on (a
    published copy, not the trainer's live tensors)."""
    calls = []

    def guard(params):
        calls.append(params)
        return len(calls) == 1, {"call": len(calls)}

    ct, gateway, _, _ = _loop(tmp_path, require_eval=guard)
    out = ct.run(max_rounds=2)
    assert out["rounds"] == 2
    assert (out["swaps_accepted"], out["swaps_refused"]) == (1, 1)
    assert gateway.weights_version == 1
    round1 = restore_checkpoint(out["checkpoints"][0])[0]["params"]
    round2 = restore_checkpoint(out["checkpoints"][1])[0]["params"]
    served = gateway.pool.live_tree()[0]
    moved = False
    for name, p in round1.items():
        assert torch.equal(served[name], p), name
        assert torch.equal(ct.state.model.state_dict()[name], round2[name])
        moved |= not torch.equal(p, round2[name])
    assert moved
    # the candidate handed to the guard was a copy too
    for name, p in calls[0].items():
        assert p.data_ptr() != ct.state.model.state_dict()[name].data_ptr()


def test_router_publisher_counts_workers_told():
    class Router:
        def __init__(self, told):
            self.told, self.calls = told, []

        def broadcast_hot_swap(self, params, require_eval=None):
            self.calls.append((params, require_eval))
            return self.told

    for told, ok in ((3, True), (0, False)):
        router = Router(told)
        assert router_publisher(router)({"w": 1}) == (
            ok, {"workers_told": told})
        assert router.calls == [({"w": 1}, None)]


def test_final_params_track_the_jax_continuous_trainer(tmp_path):
    """Two rounds from the same initial params over the same landed rows
    at dropout 0: the two loops' final params agree within PARAM_TOL."""
    rows = _rows(160, seed=5)
    first, later = rows[:100], [rows[100:160]]
    model = dict(hidden_size=HIDDEN, dropout=0.0, bidirectional=False,
                 cell="gru")
    jwh = _jax_warehouse()
    jwh.insert_rows(first)
    n_features = len(jwh.x_fields)
    jct = JaxContinuousTrainer(
        jwh, JaxModelConfig(**model, n_features=n_features,
                            use_pallas=False),
        JaxTrainConfig(**LOOP), checkpoint_dir=str(tmp_path / "jax"),
        drift_bins=8, wait_fn=_lander(jwh, later), chunk=PAGE)
    init_state = jct.trainer.init_state(jax.random.PRNGKey(3))
    init = jax.device_get(init_state.params)  # before the steps donate it
    want = jct.run(max_rounds=2, initial_state=init_state)

    wh = _port_warehouse()
    wh.insert_rows(first)
    ct = ContinuousTrainer(
        wh, ModelConfig(**model, n_features=n_features),
        TrainConfig(**LOOP), checkpoint_dir=str(tmp_path / "port"),
        drift_bins=8, wait_fn=_lander(wh, later), chunk=PAGE, device="cpu")
    got = ct.run(max_rounds=2,
                 initial_state=ct.trainer.init_state(params_from_flax(init)))
    assert got["rounds"] == want["rounds"] == 2
    assert got["rows_seen"] == want["rows_seen"] == 160
    final = params_from_flax(jax.device_get(jct._state.params))
    assert ct.state.step == int(jct._state.step)
    for name, p in ct.state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(),
                                   atol=PARAM_TOL, err_msg=name)
    for k in ("loss", "accuracy"):
        assert abs(got["last_metrics"][k] - want["last_metrics"][k]) <= 1e-5


def test_stop_ends_a_waiting_loop():
    wh = _port_warehouse()
    wh.insert_rows(_rows(20, seed=6))
    model_cfg, _ = _serving(len(wh.x_fields))
    ct = ContinuousTrainer(
        wh, model_cfg, TrainConfig(**dict(LOOP, continuous_follow_polls=50)),
        checkpoint_dir="unused", wait_fn=lambda: time.sleep(0.01),
        device="cpu")
    t = threading.Thread(target=ct.run, daemon=True)
    t.start()
    time.sleep(0.05)
    ct.stop()
    t.join(timeout=30)
    assert not t.is_alive() and ct.rounds == 0


# ---------------------------------------------------------------------------
# swaps from another thread
# ---------------------------------------------------------------------------


def test_swaps_from_a_thread_publish_every_result_once():
    """One thread swaps 50 times while another submits and pumps: every
    tick is published exactly once, under the version its flush was
    dispatched under, and the weights_version results carry never goes
    down, on the bus and per session."""
    n_sessions, feats = 8, 6
    cfg = ModelConfig(hidden_size=HIDDEN, n_features=feats, dropout=0.0,
                      bidirectional=False, cell="gru")
    params = build_model(
        cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    other = {k: v + 0.01 for k, v in params.items()}
    pool = SessionPool(cfg, params, capacity=n_sessions, window=6,
                       device="cpu")
    bus = InProcessBus(DEFAULT_TOPICS, capacity=1 << 16)
    gateway = FleetGateway(pool, bus, batcher_config=BatcherConfig(
        bucket_sizes=(4, 8), max_linger_s=0.0))
    for i in range(n_sessions):
        gateway.open_session(f"S{i}")
    # the version each tick's flush was dispatched under: its result must
    # carry that one (the swap barrier), whichever thread completes it
    at_dispatch = {}
    dispatch = gateway._dispatch

    def recording_dispatch(ticks):
        for t in ticks:
            at_dispatch[(t.handle.session_id, t.seq)] = (
                gateway.weights_version or 0)
        return dispatch(ticks)

    gateway._dispatch = recording_dispatch
    done, errors = threading.Event(), []

    def swapper():
        try:
            for k in range(50):
                gateway.hot_swap(other if k % 2 else params)
                time.sleep(0.001)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            done.set()

    rng = np.random.default_rng(0)
    returned, submitted = [], 0
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=swapper, daemon=True)
        t.start()
        for _ in range(20_000):
            if done.is_set() and submitted >= 400:
                break
            for i in rng.permutation(n_sessions)[:5]:
                gateway.submit(f"S{i}", rng.normal(size=feats).astype(
                    np.float32))
                submitted += 1
            returned.extend(gateway.pump())
        returned.extend(gateway.drain())
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive() and not errors
    assert gateway.weights_version == 50
    messages = [r.value for r in bus.consumer(TOPIC_FLEET_PREDICTION).poll()]
    keys = [(m["session"], m["seq"]) for m in messages]
    assert len(keys) == len(set(keys)) == submitted == len(returned)
    assert {(r.session_id, r.seq) for r in returned} == set(keys)
    versions = [m.get("weights_version", 0) for m in messages]
    assert versions == sorted(versions) and versions[-1] >= 1
    assert versions == [at_dispatch[k] for k in keys]
    by_session = {}
    for m in sorted(messages, key=lambda m: (m["session"], m["seq"])):
        by_session.setdefault(m["session"], []).append(
            m.get("weights_version", 0))
    assert all(v == sorted(v) for v in by_session.values())
    assert sum(gateway.version_ticks.values()) == submitted


def test_launches_by_bucket_count_the_flush_alone(monkeypatch):
    """A thread that launches kernels beside the pump (a trainer) adds
    nothing to ``kernel_launches_by_bucket``: a flush books only the
    launches its own thread made.  Here the pool's step stands for the
    ssm tick, one launch a flush, and the other thread bumps the counters
    as a wrapper does."""
    from fmda_tpu_torch import ops
    from fmda_tpu_torch.ops import gru_kernel

    monkeypatch.setattr(gru_kernel, "launches", gru_kernel.launches)
    model_cfg, gateway = _serving(6)
    step = gateway.pool.step_device

    def one_launch_a_flush(slots, rows):
        ops.count_launch()
        return step(slots, rows)

    monkeypatch.setattr(gateway.pool, "step_device", one_launch_a_flush)
    done, bumped = threading.Event(), []

    def trainer():
        while not done.is_set():
            gru_kernel.launches += 1
            ops.count_launch()
            bumped.append(1)
            time.sleep(0)

    for i in range(2):
        gateway.open_session(f"S{i}")
    before = ops.total_launches()
    t = threading.Thread(target=trainer, daemon=True)
    t.start()
    try:
        rng = np.random.default_rng(0)
        for _ in range(200):
            for i in range(2):
                gateway.submit(f"S{i}", rng.normal(size=6).astype(np.float32))
            gateway.pump()
        gateway.drain()
    finally:
        done.set()
        t.join(timeout=10)
    flushes = gateway.metrics.counters["flushes"]
    assert flushes > 0 and bumped
    assert gateway.kernel_launches_by_bucket == {4: flushes}
    assert ops.total_launches() - before == len(bumped)
