"""fmda_tpu_torch.chaos.pipeline against fmda_tpu.chaos.pipeline, on the CPU.

The data-plane soak (synthetic feeds → engine → journaled warehouse →
Predictor) at the reference's fast tier-1 size (18 rounds: a feed outage,
a warehouse outage and an engine kill): the same plan, gates, ``ingested``,
``landed``, losses, ``degraded_rows`` and journal counts, the landed rows
bit for bit; the Predictor's probabilities within 1e-5 of the reference's
with its initial weights carried across (``interop.params_from_flax``);
``chaos-pipeline``'s exit codes as the reference's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fmda_tpu.chaos.pipeline as jax_pipeline
import fmda_tpu.cli as jax_cli
from fmda_tpu.chaos.plan import FaultEvent as JaxFaultEvent
from fmda_tpu.chaos.plan import FaultPlan as JaxFaultPlan

import fmda_tpu_torch.chaos.pipeline as pipeline
from fmda_tpu_torch.__main__ import main as port_main
from fmda_tpu_torch.chaos import default_chaos
from fmda_tpu_torch.chaos.plan import FaultEvent, FaultPlan
from fmda_tpu_torch.interop import params_from_flax

TOL = 1e-5
#: the reference tests' fast plan: feed outage, warehouse outage, engine
#: kill in one 18-round run
FAST_EVENTS = ((3, "kill", "feed:vix", 5), (10, "kill", "warehouse.append",
                                            3), (15, "kill", "engine.step", 2))


def _fast_plan(plan_cls, event_cls):
    return plan_cls(n_steps=18, seed=99, events=tuple(
        event_cls(s, k, t, duration=d) for s, k, t, d in FAST_EVENTS))


@pytest.mark.parametrize("seed,rounds", [(0, 30), (5, 30), (7, 18), (0, 60)])
def test_generated_pipeline_plan_is_the_reference(seed, rounds):
    got = pipeline.generate_pipeline_plan(seed, rounds)
    ref = jax_pipeline.generate_pipeline_plan(seed, rounds)
    assert json.dumps(got.to_wire(), sort_keys=True) == json.dumps(
        ref.to_wire(), sort_keys=True)
    assert pipeline.PIPELINE_LOSS_FIELDS == jax_pipeline.PIPELINE_LOSS_FIELDS
    assert pipeline.SIDE_FEED_TOPICS == jax_pipeline.SIDE_FEED_TOPICS


RUN_KW = dict(seed=0, rounds=18, bars_per_round=2, probe_rounds=2,
              staleness_deadline_s=450, checkpoint_every=3,
              journal_bound=4096, predictor=False, window=8, hidden=4,
              work_dir=None)


def test_fast_soak_matches_the_reference_row_for_row():
    """The faulted run's state, field by field, and its landed rows byte
    for byte; the gated report equal, every gate green."""
    got = pipeline._run_pipeline(_fast_plan(FaultPlan, FaultEvent),
                                 device=None, **RUN_KW)
    ref = jax_pipeline._run_pipeline(_fast_plan(JaxFaultPlan, JaxFaultEvent),
                                     **RUN_KW)
    assert set(got) == set(ref)
    for key in ref:
        assert got[key] == ref[key], key
    assert got["landed_raw"] and got["landed_raw"] == ref["landed_raw"]
    report = pipeline._gate_report(_fast_plan(FaultPlan, FaultEvent), got,
                                   predictor=False)
    assert report == jax_pipeline._gate_report(
        _fast_plan(JaxFaultPlan, JaxFaultEvent), ref, predictor=False)
    assert all(report["gates"].values()), report["gates"]
    assert report["degraded_rows"].get("vix", 0) > 0
    assert report["journal"]["spilled_rows"] > 0
    assert report["journal"]["pending"] == 0
    assert report["engine_restarts"] == 1 and report["unaccounted"] == 0
    assert not default_chaos().enabled


def test_fast_soak_report_with_identity_is_the_reference():
    kw = dict(rounds=18, probe_rounds=2, compare_unfaulted=True)
    got = pipeline.run_pipeline_soak(_fast_plan(FaultPlan, FaultEvent), **kw)
    ref = jax_pipeline.run_pipeline_soak(
        _fast_plan(JaxFaultPlan, JaxFaultEvent), **kw)
    assert got == ref
    assert got["gates_ok"] and got["identity"]["clean_rows"] > 0
    # one plan, two runs: the same report (the reproduction recipe)
    assert pipeline.run_pipeline_soak(
        _fast_plan(FaultPlan, FaultEvent), **kw) == got


def _recording_factory(build, served):
    """A ``_build_predictor`` stand-in: ``build``'s Predictor, its polls
    recorded into ``served`` (timestamp -> probabilities)."""
    def factory(*args, **kw):
        pred = build(*args, **kw)
        poll = pred.poll

        def recorded():
            out = poll()
            for p in out:
                served[p.timestamp] = np.asarray(p.probabilities, np.float64)
            return out

        pred.poll = recorded
        return pred

    return factory


def test_predictor_soak_matches_the_reference_within_tolerance(monkeypatch):
    """``predictor=True``: the port's Predictor built from the reference's
    initial weights (``_build_predictor`` patched to carry them across)
    serves the reference's signals, each probability within 1e-5, on the
    CPU."""
    from fmda_tpu.config import ModelConfig as JaxModelConfig
    from fmda_tpu.models import build_model as jax_build_model

    from fmda_tpu_torch.config import ModelConfig
    from fmda_tpu_torch.data.normalize import NormParams
    from fmda_tpu_torch.serve.predictor import Predictor

    window, hidden, seed = 8, 4, 0

    def carried(bus, warehouse, fc, *, window, hidden, seed, device=None):
        fields = dict(hidden_size=hidden, n_features=fc.n_features,
                      dropout=0.0)
        params = jax.device_get(jax_build_model(JaxModelConfig(
            **fields)).init({"params": jax.random.PRNGKey(seed)},
                            jnp.zeros((1, window, fc.n_features),
                                      jnp.float32))["params"])
        norm = NormParams(np.zeros(fc.n_features, np.float32),
                          np.ones(fc.n_features, np.float32))
        return Predictor(bus, warehouse, ModelConfig(**fields),
                         params_from_flax(params), norm, window=window,
                         from_end=False, max_staleness_s=None,
                         device=device)

    served_ref, served = {}, {}
    monkeypatch.setattr(jax_pipeline, "_build_predictor", _recording_factory(
        jax_pipeline._build_predictor, served_ref))
    monkeypatch.setattr(pipeline, "_build_predictor", _recording_factory(
        carried, served))
    kw = dict(rounds=18, probe_rounds=2, predictor=True, window=window,
              hidden=hidden, seed=seed, compare_unfaulted=False)
    ref = jax_pipeline.run_pipeline_soak(
        _fast_plan(JaxFaultPlan, JaxFaultEvent), **kw)
    got = pipeline.run_pipeline_soak(_fast_plan(FaultPlan, FaultEvent),
                                     device="cpu", **kw)
    assert got == ref and got["gates_ok"]
    assert got["gates"]["post_chaos_probes_served"]
    assert sorted(served) == sorted(served_ref) and len(served) > 10
    for ts, probs in served_ref.items():
        np.testing.assert_allclose(served[ts], probs, atol=TOL, rtol=0,
                                   err_msg=ts)


def test_predictor_soak_needs_a_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.run_pipeline_soak(rounds=4, predictor=True,
                                   compare_unfaulted=False)
    assert not default_chaos().enabled
    # the data plane alone needs no card (and no torch)
    assert pipeline.run_pipeline_soak(rounds=4, compare_unfaulted=False)[
        "gates_ok"]


@pytest.mark.parametrize("plan_events,extra", [
    (None, ["--rounds", "18", "--no-reference"]),
    (FAST_EVENTS, ["--rounds", "18"]),
    # the book feed down: no join stress, so no degraded rows, and the
    # degraded_entered gate fails: exit 1 on both
    (((3, "kill", "feed:deep", 4),), ["--rounds", "12", "--no-reference"]),
])
def test_chaos_pipeline_exit_codes_are_the_reference(plan_events, extra,
                                                     tmp_path, capsys):
    argv = ["chaos-pipeline", "--no-predictor"] + extra
    if plan_events is not None:
        path = tmp_path / "plan.json"
        FaultPlan(n_steps=int(extra[1]), seed=1, events=tuple(
            FaultEvent(s, k, t, duration=d) for s, k, t, d in plan_events)
        ).save(str(path))
        argv += ["--plan", str(path)]
    rc_ref = jax_cli.main(argv)
    ref = json.loads(capsys.readouterr().out)
    rc = port_main(argv)
    got = json.loads(capsys.readouterr().out)
    assert rc == rc_ref == (0 if got["gates_ok"] else 1)
    assert got == ref
    assert rc == (1 if plan_events and plan_events[0][2] == "feed:deep"
                  else 0)


def test_chaos_pipeline_serves_its_predictor_on_the_cpu(capsys):
    assert port_main(["chaos-pipeline", "--rounds", "18", "--no-reference",
                      "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["gates"]["post_chaos_probes_served"] and out["served"] > 0
