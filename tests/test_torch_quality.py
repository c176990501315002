"""fmda_tpu_torch's label-join evaluator against ``fmda_tpu.obs.quality``
on the CPU: the same captures (mixed weights versions, duplicates, ring
overflow, unjoinable timestamps, card-shaped tensors) over warehouses
holding the same rows, joined round by round on the same clock, give the
same counts, per-version accuracy and F-beta, drift PSI, conservation,
registry families and recorded series (within 1e-12 where a float sum
may run in another order); and the ``quality`` command renders the
document."""

import json

import numpy as np
import pytest
import torch

from fmda_tpu.config import FeatureConfig as JaxFeatureConfig
from fmda_tpu.config import QualityConfig as JaxQualityConfig
from fmda_tpu.config import WarehouseConfig as JaxWarehouseConfig
from fmda_tpu.eval.drift import DriftMonitor as JaxDriftMonitor
from fmda_tpu.eval.drift import build_profile as jax_build_profile
from fmda_tpu.obs.quality import QualityEvaluator as JaxQualityEvaluator
from fmda_tpu.stream import Warehouse as JaxWarehouse

from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.config import FeatureConfig, QualityConfig, WarehouseConfig
from fmda_tpu_torch.data.synthetic import random_walk_rows
from fmda_tpu_torch.eval.drift import DriftMonitor, build_profile
from fmda_tpu_torch.obs.quality import QualityEvaluator
from fmda_tpu_torch.stream import Warehouse

TOL = 1e-12
ROWS = 120


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Store:
    """Records what the evaluator publishes into a time-series store."""

    def __init__(self):
        self.calls = []

    def record_counter(self, name, value, t, **labels):
        self.calls.append(("counter", name, value, t, labels))

    def record_gauge(self, name, value, t, **labels):
        self.calls.append(("gauge", name, value, t, labels))


def _close(a, b):
    """Equal, floats within TOL, through dicts, lists and tuples."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b)) <= TOL
    return a == b


def _captures(rng, stamps):
    """(ticker, timestamp, probabilities, version, features) in order: two
    versions, a duplicate key, timestamps never landed."""
    out = []
    for i in range(90):
        ts = stamps[i % len(stamps)] if i % 17 else "1999-01-01 00:00:00"
        version = None if i < 20 else (1 if i < 60 else 2)
        out.append((f"T{i % 3}", ts, rng.uniform(size=4).astype(np.float32),
                    version, rng.normal(size=6)))
    out.insert(31, out[30])  # a duplicate key: the earlier one is shed
    return out


def _profile(build, rng):
    return build(rng.normal(size=(256, 6)),
                 rng.uniform(size=(256, 4)) > 0.6, bins=8)


def _run(name, wh_rows_first, wh_rows_later, capacity, as_tensor,
         attempts=3):
    """One evaluator over a warehouse that holds ``wh_rows_first`` rows
    during the captures and ``wh_rows_later`` more from the late joins."""
    if name == "port":
        cls, qcfg, drift, build = (QualityEvaluator, QualityConfig,
                                   DriftMonitor, build_profile)
        wh = Warehouse(FeatureConfig(), WarehouseConfig(path=":memory:"))
    else:
        cls, qcfg, drift, build = (JaxQualityEvaluator, JaxQualityConfig,
                                   JaxDriftMonitor, jax_build_profile)
        wh = JaxWarehouse(JaxFeatureConfig(),
                          JaxWarehouseConfig(path=":memory:"))
    wh.insert_rows(wh_rows_first)
    stamps = [r["Timestamp"] for r in wh_rows_first + wh_rows_later]
    rng = np.random.default_rng(9)
    clock, store = Clock(), Store()
    ev = cls(qcfg(capture_capacity=capacity, max_join_attempts=attempts,
                  join_interval_s=5.0),
             warehouse=wh, max_lead=15, store=store, clock=clock,
             drift=drift(_profile(build, rng), min_samples=16))
    joined = []
    for k, (ticker, ts, probs, version, feats) in enumerate(
            _captures(rng, stamps)):
        if as_tensor:
            probs = torch.from_numpy(probs)
        ev.capture(ticker, ts, probs, weights_version=version,
                   features=feats)
        if k % 10 == 9:
            clock.t += 3.0
            joined.append(ev.maybe_join())
    wh.insert_rows(wh_rows_later)
    for _ in range(4):
        clock.t += 10.0
        joined.append(ev.maybe_join())
    doc = dict(joined=joined, summary=ev.summary(), families=ev.families(),
               conservation=ev.conservation(), store=store.calls)
    wh.close()
    return doc


@pytest.mark.parametrize("capacity,as_tensor,attempts", [
    (4096, False, 3), (40, False, 3), (4096, True, 3), (4096, False, 8)])
def test_join_rounds_equal_the_reference(capacity, as_tensor, attempts):
    rows = random_walk_rows(FeatureConfig().table_columns(), ROWS, seed=3)
    first, later = rows[:ROWS // 2], rows[ROWS // 2:]
    port = _run("port", first, later, capacity, as_tensor, attempts)
    ref = _run("ref", first, later, capacity, False, attempts)
    assert port["joined"] == ref["joined"]
    assert port["conservation"] == ref["conservation"]
    assert _close(port["summary"], ref["summary"])
    assert _close(port["families"], ref["families"])
    assert _close(port["store"], ref["store"])
    c = port["conservation"]
    assert c["captured"] == 91
    assert c["captured"] == (c["joined"] + c["expired"] + c["shed"]
                             + c["pending"])
    assert c["joined"] > 0 and c["shed"] >= 1
    if capacity == 4096 and attempts == 3:
        assert c["expired"] > 0  # the never-landed timestamps age out
    assert set(port["summary"]["versions"]) >= {"0", "1", "2"}
    assert port["summary"]["drift"]["max_psi"] >= 0


def test_quality_command_renders_the_document(tmp_path, capsys):
    rows = random_walk_rows(FeatureConfig().table_columns(), ROWS, seed=3)
    doc = _run("port", rows, [], 4096, False)["summary"]
    (tmp_path / "quality.json").write_text(json.dumps(doc))
    assert port_main(["quality", "--bundle", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "model quality" in text and "captured 91 =" in text
    assert "overall" in text and "v1" in text and "drift: max PSI" in text
    assert port_main(["quality", "--artifact",
                      str(tmp_path / "quality.json"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == doc
    assert port_main(["quality"]) == 2
    assert port_main(["quality", "--bundle", str(tmp_path / "none")]) == 2


def test_quality_config_defaults_equal_the_reference():
    import dataclasses

    ours, ref = QualityConfig(), JaxQualityConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
