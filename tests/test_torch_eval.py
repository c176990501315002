"""fmda_tpu_torch.eval and train.reports against fmda_tpu's, on the same
numpy-seeded data: the streaming metric counts, the drift profile (its
JSON key for key), PSI and the drift monitor's scores, and the report
tables (the same strings)."""

import json
import os

import numpy as np
import pytest

from fmda_tpu.eval import drift as jax_drift
from fmda_tpu.eval import metrics as jax_metrics
from fmda_tpu.train import reports as jax_reports
from fmda_tpu.train.trainer import EpochMetrics as JaxEpochMetrics

import fmda_tpu_torch.eval as port_eval
from fmda_tpu_torch.eval import drift, metrics
from fmda_tpu_torch.train import EpochMetrics, reports

N_LABELS = 4
SCORE_TOL = 1e-12


def _preds(seed, n=64, p=0.4):
    r = np.random.default_rng(seed)
    probs = r.random((n, N_LABELS)).astype(np.float32)
    target = r.random((n, N_LABELS)) < p
    return probs, target


def _same_counts(got, want):
    assert (got.n, got.exact, got.wrong) == (want.n, want.exact, want.wrong)
    for k in ("tp", "fp", "fn", "tn"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    np.testing.assert_array_equal(got.confusion(), want.confusion())
    for beta in (0.5, 1.0, 2.0):
        np.testing.assert_array_equal(got.fbeta(beta), want.fbeta(beta))
        assert got.summary(beta) == want.summary(beta)
    assert got.subset_accuracy == want.subset_accuracy
    assert got.hamming_loss == want.hamming_loss


def test_eval_exports_the_reference_names():
    import fmda_tpu.eval as ref

    assert sorted(port_eval.__all__) == sorted(ref.__all__)
    assert "ShadowEvaluator" not in port_eval.__all__


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.8])
def test_threshold_and_batch_counts_match_the_reference(threshold):
    probs, target = _preds(0)
    np.testing.assert_array_equal(
        metrics.threshold_probs(probs, threshold),
        jax_metrics.threshold_probs(probs, threshold))
    _same_counts(metrics.batch_counts(probs, target, threshold=threshold),
                 jax_metrics.batch_counts(probs, target, threshold=threshold))


def test_streaming_updates_and_merges_equal_the_batch_counts():
    parts = [_preds(s, n=n) for s, n in ((1, 17), (2, 40), (3, 1))]
    port, ref = metrics.StreamingCounts(N_LABELS), \
        jax_metrics.StreamingCounts(N_LABELS)
    merged = metrics.StreamingCounts(N_LABELS)
    for probs, target in parts:
        pred = probs > 0.5
        port.update(pred, target)
        ref.update(pred, target)
        one = metrics.StreamingCounts(N_LABELS)
        one.update(pred, target)
        merged.merge(one)
    _same_counts(port, ref)
    _same_counts(merged, ref)
    whole = jax_metrics.batch_counts(
        np.concatenate([p for p, _ in parts]),
        np.concatenate([t for _, t in parts]))
    _same_counts(port, whole)
    with pytest.raises(ValueError, match="different n_labels"):
        port.merge(metrics.StreamingCounts(N_LABELS + 1))
    with pytest.raises(ValueError, match="shape mismatch"):
        port.update(np.zeros((2, 3), bool), np.zeros((2, 3), bool))
    with pytest.raises(ValueError, match="positive"):
        metrics.StreamingCounts(0)


def test_zero_over_zero_and_the_confusion_layout():
    # label 0 never predicted nor true (0/0 -> 0), label 1 all true
    # positives, label 2 all false positives, label 3 all false negatives
    pred = np.array([[0, 1, 1, 0], [0, 1, 1, 0]], bool)
    target = np.array([[0, 1, 0, 1], [0, 1, 0, 1]], bool)
    for mod in (metrics, jax_metrics):
        c = mod.StreamingCounts(N_LABELS)
        c.update(pred, target)
        np.testing.assert_array_equal(c.fbeta(0.5), [0.0, 1.0, 0.0, 0.0])
        np.testing.assert_array_equal(
            c.confusion(), [[[2, 0], [0, 0]], [[0, 0], [0, 2]],
                            [[0, 2], [0, 0]], [[0, 0], [2, 0]]])
    empty = metrics.StreamingCounts(N_LABELS)
    assert empty.subset_accuracy == empty.hamming_loss == 0.0
    _same_counts(empty, jax_metrics.StreamingCounts(N_LABELS))


def _rows(seed, n=500, f=5, shift=0.0):
    r = np.random.default_rng(seed)
    rows = r.normal(size=(n, f)) + shift
    rows[:, 2] = 1.5  # a constant feature: its quantiles collapse
    targets = (r.random((n, N_LABELS)) < 0.3).astype(np.float32)
    return rows.astype(np.float32), targets


@pytest.mark.parametrize("bins,with_targets", [(10, True), (16, False),
                                               (2, True)])
def test_build_profile_is_the_reference_json_key_for_key(
        tmp_path, bins, with_targets):
    rows, targets = _rows(4)
    columns = [f"c{i}" for i in range(rows.shape[1])]
    args = (rows, targets if with_targets else None)
    got = drift.build_profile(*args, bins=bins, columns=columns)
    want = jax_drift.build_profile(*args, bins=bins, columns=columns)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    path = drift.save_profile(str(tmp_path / "p.json"), got)
    ref_path = jax_drift.save_profile(str(tmp_path / "r.json"), want)
    with open(path) as a, open(ref_path) as b:
        assert a.read() == b.read()
    assert drift.load_profile(ref_path) == jax_drift.load_profile(path)
    with pytest.raises(ValueError, match="need >= 2"):
        drift.build_profile(rows[:1])
    with pytest.raises(ValueError, match="need >= 2 bins"):
        drift.build_profile(rows, bins=1)


def test_load_profile_refuses_another_version(tmp_path):
    rows, _ = _rows(5)
    profile = dict(drift.build_profile(rows), profile_version=99)
    path = str(tmp_path / "p.json")
    drift.save_profile(path, profile)
    with pytest.raises(ValueError, match="unsupported quality profile"):
        drift.load_profile(path)


def test_profile_path_sits_beside_the_one_file_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpts" / "step_00000008.pt")
    assert drift.profile_path_for(ckpt) == str(
        tmp_path / "ckpts" / "step_00000008.quality_profile.json")
    # the reference's file name, beside the file instead of inside the
    # reference's checkpoint directory
    assert drift.profile_path_for(ckpt).endswith(
        "." + os.path.basename(jax_drift.profile_path_for(str(tmp_path))))


def test_psi_matches_the_reference():
    r = np.random.default_rng(6)
    for _ in range(20):
        a, b = r.random(8), r.random(8)
        a[r.integers(8)] = 0.0  # an empty bin: the smoothing floor
        assert abs(drift.psi(a, b) - jax_drift.psi(a, b)) <= SCORE_TOL
    assert drift.psi([0.5, 0.5], [0.5, 0.5]) == 0.0


@pytest.mark.parametrize("shift", [0.0, 0.7])
def test_drift_monitor_scores_match_the_reference(shift):
    rows, targets = _rows(7)
    profile = drift.build_profile(rows, targets, bins=10)
    port = drift.DriftMonitor(profile, min_samples=64)
    ref = jax_drift.DriftMonitor(profile, min_samples=64)
    live, _ = _rows(8, n=300, shift=shift)
    r = np.random.default_rng(9)
    for lo in range(0, len(live), 50):
        batch = live[lo:lo + 50]
        preds = r.random((len(batch), N_LABELS)) < 0.4
        for mon in (port, ref):
            mon.observe_features(batch)
            mon.observe_predictions(preds)
        got, want = port.scores(), ref.scores()
        if want is None:
            assert got is None and port.n_rows < 64
            continue
        assert got.keys() == want.keys() and got["rows"] == want["rows"]
        for key in ("feature_psi", "prediction_psi"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=SCORE_TOL)
        assert abs(got["max_psi"] - want["max_psi"]) <= SCORE_TOL
    assert port.scores()["max_psi"] > (0.1 if shift else -1.0)
    with pytest.raises(ValueError, match="row width"):
        port.observe_features(np.zeros((1, 3)))


def test_history_and_quality_tables_are_the_reference_strings():
    r = np.random.default_rng(10)

    def epochs(cls):
        vals = r.random((3, 3))
        return [cls(*v, np.zeros(N_LABELS)) for v in vals]

    port_hist = {"train": epochs(EpochMetrics), "val": epochs(EpochMetrics)}
    ref_hist = {k: [JaxEpochMetrics(*m) for m in v]
                for k, v in port_hist.items()}
    assert reports.history_table(port_hist) == \
        jax_reports.history_table(ref_hist)
    probs, target = _preds(11, n=200)
    got = reports.offline_quality(probs, target, threshold=0.4)
    want = jax_reports.offline_quality(probs, target, threshold=0.4)
    _same_counts(got, want)
    for kw in ({}, {"beta": 1.0, "title": "val split"}):
        assert reports.quality_table(got, **kw) == \
            jax_reports.quality_table(want, **kw)
