"""fmda_tpu_torch's write-ahead journal (``BufferedWarehouse``) against
``fmda_tpu.stream.journal`` in both record layouts: spill while the store
is down, drain when it is back, recovery of a journal with a torn last
record (each package reading the other's file too), shedding at the bound,
the dedupe overrides, and the engine landing through it across an outage.
The journal files are byte-equal to the reference's for the same rows."""

import os

import numpy as np
import pytest

from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.stream import InProcessBus as JaxBus
from fmda_tpu.stream import StreamEngine as JaxEngine
from fmda_tpu.stream import Warehouse as JaxWarehouse
from fmda_tpu.stream.journal import BufferedWarehouse as JaxBuffered

from fmda_tpu_torch.config import (
    DEFAULT_TOPICS,
    TOPIC_PREDICT_TIMESTAMP,
    FeatureConfig,
    WarehouseConfig,
)
from fmda_tpu_torch.stream import (
    BufferedWarehouse,
    InProcessBus,
    StreamEngine,
    Warehouse,
)
from fmda_tpu_torch.stream.journal import JOURNAL_FORMATS

from test_stream import _session_messages

FEATURES = dict(bid_levels=2, ask_levels=2, event_list=("Core CPI",),
                get_cot=False)
PACKAGES = {
    "fmda_tpu": (JaxFeatureConfig, JaxWarehouseConfig, JaxWarehouse,
                 JaxBuffered, JaxBus, JaxEngine),
    "fmda_tpu_torch": (FeatureConfig, WarehouseConfig, Warehouse,
                       BufferedWarehouse, InProcessBus, StreamEngine),
}


class FlakyStore:
    """A warehouse whose writes fail while ``down``, as an unreachable
    store's do."""

    def __init__(self, inner):
        self.inner = inner
        self.down = False

    def insert_rows(self, rows):
        if self.down:
            raise ConnectionError("store unreachable")
        return self.inner.insert_rows(rows)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self):
        return len(self.inner)


def _rows(n, seed=0, start=0):
    """Seeded joined-row dicts over the narrow schema's table columns."""
    cols = FeatureConfig(**FEATURES).table_columns()
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, len(cols))) * 100
    return [{"Timestamp": f"2020-02-07 {9 + (start + i) // 12:02d}:"
                          f"{5 * ((start + i) % 12):02d}:00",
             **{c: float(v) for c, v in zip(cols, row)}}
            for i, row in enumerate(vals)]


def _buffered(pkg, path, **kw):
    fcls, wcls, whcls, bcls = PACKAGES[pkg][:4]
    store = FlakyStore(whcls(fcls(**FEATURES), wcls(path=":memory:")))
    return store, bcls(store, path, **kw)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _landed(store):
    return store.inner.raw_rows_for(store.inner.timestamps())


@pytest.mark.parametrize("fmt", JOURNAL_FORMATS)
def test_spill_and_drain_equal_the_reference(tmp_path, fmt):
    out = {}
    for pkg in PACKAGES:
        path = str(tmp_path / f"{pkg}.journal")
        store, wh = _buffered(pkg, path, fmt=fmt)
        wh.insert_rows(_rows(2, seed=1, start=0))
        store.down = True
        spilled = [wh.insert_rows(_rows(3, seed=2, start=2)),
                   wh.insert_rows(_rows(4, seed=3, start=5))]
        during = (_read(path), wh.journal_stats(),
                  wh.has_timestamp(_rows(1, start=6)[0]["Timestamp"]),
                  wh.recent_timestamps(3))
        assert wh.drain_journal() == 0  # still down: nothing lands
        store.down = False
        wh.insert_rows(_rows(2, seed=4, start=9))
        out[pkg] = (spilled, during, _read(path), wh.journal_stats(),
                    _landed(store), store.inner.timestamps())
    ours, ref = out["fmda_tpu_torch"], out["fmda_tpu"]
    assert ours == ref
    spilled, during, after, stats, _, order = ours
    assert spilled == [3, 4] and during[1]["spilled_rows"] == 7
    assert during[1]["pending"] == 7 and during[2] is True
    assert len(during[0]) > 0 and after == b""
    assert stats["backfilled_rows"] == 7 and stats["pending"] == 0
    assert stats["drain_failures"] == 2  # the second spill's and ours
    assert order == [r["Timestamp"] for r in _rows(11)]
    if fmt == "binary":
        assert during[0][:1] != b"{" and during[0][4] == 0xFB


@pytest.mark.parametrize("fmt", JOURNAL_FORMATS)
@pytest.mark.parametrize("writer", list(PACKAGES))
def test_recovery_drops_a_torn_last_record(tmp_path, fmt, writer):
    """A journal left behind with a torn trailing record (a kill
    mid-write) recovers in either package, the torn record counted, and
    drains into the store."""
    path = str(tmp_path / "written.journal")
    store, wh = _buffered(writer, path, fmt=fmt)
    store.down = True
    wh.insert_rows(_rows(3, seed=5))
    wh.insert_rows(_rows(2, seed=6, start=3))
    data = _read(path)
    torn = data + (b'{"Timestamp": "2020-02-07 12:' if fmt == "jsonl"
                   else data[:9])
    out = {}
    for pkg in PACKAGES:
        copy = str(tmp_path / f"{pkg}.journal")
        with open(copy, "wb") as fh:
            fh.write(torn)
        store, wh = _buffered(pkg, copy, fmt=fmt)
        recovered = (wh.journal_stats(), _read(copy))
        wh.drain_journal()
        out[pkg] = (recovered, wh.journal_stats(), _landed(store))
    assert out["fmda_tpu_torch"] == out["fmda_tpu"]
    (stats, compacted), after, landed = out["fmda_tpu_torch"]
    assert stats["recovered_rows"] == 5 and stats["corrupt_lines"] == 1
    if fmt == "jsonl":  # the torn line compacted away, the rest kept
        assert compacted == data
    assert after["backfilled_rows"] == 5 and len(landed) == 5


@pytest.mark.parametrize("fmt", JOURNAL_FORMATS)
def test_shedding_at_the_bound(tmp_path, fmt):
    out = {}
    for pkg in PACKAGES:
        path = str(tmp_path / f"{pkg}.journal")
        store, wh = _buffered(pkg, path, fmt=fmt, bound=5)
        store.down = True
        wh.insert_rows(_rows(3, seed=7))
        wh.insert_rows(_rows(5, seed=8, start=3))
        shed = (_read(path), wh.journal_stats())
        store.down = False
        wh.drain_journal()
        out[pkg] = (shed, wh.journal_stats(), _landed(store))
    assert out["fmda_tpu_torch"] == out["fmda_tpu"]
    (_, stats), _, landed = out["fmda_tpu_torch"]
    assert stats["shed_rows"] == 3 and stats["pending"] == 5
    assert sorted(landed) == [r["Timestamp"] for r in _rows(8)][3:]


def test_journal_refuses_an_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="journal format"):
        _buffered("fmda_tpu_torch", str(tmp_path / "j"), fmt="csv")


@pytest.mark.parametrize("fmt", JOURNAL_FORMATS)
def test_engine_lands_through_an_outage(tmp_path, fmt):
    """The engine over a BufferedWarehouse: rows of the outage journal and
    signal; an idle step after recovery drains them, as the reference's
    engine does."""
    out = {}
    for pkg, (fcls, wcls, whcls, bcls, buscls, engcls) in PACKAGES.items():
        fc = fcls(**FEATURES)
        store = FlakyStore(whcls(fc, wcls(path=":memory:")))
        wh = bcls(store, str(tmp_path / f"{pkg}.journal"), fmt=fmt)
        bus = buscls(DEFAULT_TOPICS)
        eng = engcls(bus, wh, fc)
        msgs = _session_messages(6)
        for i, (topic, msg) in enumerate(msgs):
            bus.publish(topic, msg)
            if i == 7:
                eng.step()
                store.down = True
        eng.step()
        during = (wh.journal_stats()["pending"], len(store))
        store.down = False
        eng.step()  # idle: the drain backfills
        n = len(store)
        out[pkg] = (during, wh.journal_stats(), n, eng.stats,
                    [r.value for r in bus.read(TOPIC_PREDICT_TIMESTAMP, 0)],
                    store.inner.fetch(range(1, n + 1)).tobytes())
    assert out["fmda_tpu_torch"] == out["fmda_tpu"]
    during, stats, n = out["fmda_tpu_torch"][:3]
    assert during == (4, 2) and stats["backfilled_rows"] == 4 and n == 6
    assert len(out["fmda_tpu_torch"][4]) == 6
