"""fmda_tpu_torch's TemporalTransformer (``cell="attn"``) and its config
against the JAX package's, on the CPU.

The flax model is initialised from a seed, its params cross-load through
``params_from_flax``, and numpy-seeded windows go through both in eval
mode (dropout off: the two frameworks' random bits cannot match): logits
and the parameter gradients of a scalar loss agree to 1e-5 in float32, at
the model's full width (H = 32, F = 108, 4 heads, T = 30) and at a
deeper small one.  Then the config loader: the port refuses the typos the
reference refuses, and its table of the reference's keys is the
reference's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fmda_tpu.config as jax_config
from fmda_tpu.models import build_model as jax_build_model
from fmda_tpu.models.attn import sinusoidal_positions as jax_positions

from fmda_tpu_torch import config
from fmda_tpu_torch.config import FrameworkConfig, ModelConfig
from fmda_tpu_torch.data.normalize import NormParams
from fmda_tpu_torch.interop import load_flax_npz, params_from_flax, save_flax_npz
from fmda_tpu_torch.models import TemporalTransformer, build_model
from fmda_tpu_torch.models.attn import sinusoidal_positions
from fmda_tpu_torch.runtime import SessionPool
from fmda_tpu_torch.serve import StreamingBiGRU

TOL = 1e-5
BF16_TOL = 2e-2


def _jax_params(cfg, seed=0, steps=7):
    model = jax_build_model(cfg)
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        jnp.zeros((1, steps, cfg.n_features)))["params"]
    return model, jax.device_get(params)


def _port(cfg, flax_params):
    model = build_model(cfg)
    assert type(model) is TemporalTransformer
    model.load_state_dict(params_from_flax(flax_params), strict=True)
    return model.eval()


def _ragged_mask(batch, steps, seed=5):
    lengths = np.random.default_rng(seed).integers(1, steps + 1, size=batch)
    return np.arange(steps)[None, :] < lengths[:, None]


def _logits_and_grads(jax_model, params, port, x, mask, seed):
    """Both models' logits and the gradients of sum(logits * w) in the
    port's names."""
    w = np.random.default_rng(seed).normal(
        size=(x.shape[0], port.cfg.output_size)).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(p):
        logits = jax_model.apply({"params": p}, x, mask=jmask)
        return jnp.sum(logits * w), logits

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    got = port(torch.from_numpy(x),
               mask=None if mask is None else torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    grads = {k: p.grad for k, p in port.named_parameters()}
    return got, np.asarray(want), grads, params_from_flax(
        jax.device_get(jgrads))


def _check(got, want, grads, want_grads):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)
    assert grads.keys() == want_grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(),
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_full_width_transformer_matches_jax(masked):
    jax_cfg = dataclasses.replace(jax_config.FrameworkConfig().model,
                                  cell="attn")
    cfg = dataclasses.replace(FrameworkConfig().model, cell="attn")
    assert (cfg.hidden_size, cfg.n_features, cfg.n_heads, cfg.n_layers) == (
        32, 108, 4, 1)
    assert (cfg.hidden_size, cfg.n_features, cfg.n_heads) == (
        jax_cfg.hidden_size, jax_cfg.n_features, jax_cfg.n_heads)
    jax_model, params = _jax_params(jax_cfg, seed=1, steps=30)
    port = _port(cfg, params)
    x = np.random.default_rng(6).normal(size=(4, 30, 108)).astype(np.float32)
    mask = _ragged_mask(4, 30) if masked else None
    _check(*_logits_and_grads(jax_model, params, port, x, mask, seed=2))


@pytest.mark.parametrize("masked", [False, True])
def test_full_width_transformer_matches_jax_in_bf16(masked):
    """The logits of 8 windows with ``dtype="bfloat16"`` (params float32 on
    both sides): the two frameworks round the bf16 compute at other
    places, so 2e-2."""
    jax_cfg = dataclasses.replace(jax_config.FrameworkConfig().model,
                                  cell="attn", dtype="bfloat16")
    cfg = dataclasses.replace(FrameworkConfig().model, cell="attn",
                              dtype="bfloat16")
    jax_model, params = _jax_params(jax_cfg, seed=1, steps=30)
    port = _port(cfg, params)
    x = np.random.default_rng(8).normal(size=(8, 30, 108)).astype(np.float32)
    mask = _ragged_mask(8, 30) if masked else None
    want = jax_model.apply({"params": params}, x,
                           mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=BF16_TOL,
                               rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_deeper_small_transformer_matches_jax(causal, masked):
    fields = dict(hidden_size=8, n_features=6, n_heads=2, n_layers=2,
                  cell="attn", attn_causal=causal, dropout=0.0)
    jax_model, params = _jax_params(jax_config.ModelConfig(**fields))
    port = _port(ModelConfig(**fields), params)
    x = np.random.default_rng(int(causal)).normal(
        size=(3, 7, 6)).astype(np.float32)
    mask = _ragged_mask(3, 7) if masked else None
    _check(*_logits_and_grads(jax_model, params, port, x, mask, seed=3))


@pytest.mark.parametrize("dim", [1, 7, 8, 32])
def test_sinusoidal_positions_match_jax(dim):
    got = sinusoidal_positions(30, dim)
    want = np.asarray(jax_positions(30, dim, jnp.float32))
    assert got.shape == (30, dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_params_from_flax_reads_the_attn_tree(tmp_path):
    cfg = jax_config.ModelConfig(hidden_size=8, n_features=5, n_heads=2,
                                 n_layers=2, cell="attn")
    _, params = _jax_params(cfg)
    state = params_from_flax(params)
    # Dense kernels transposed to (out, in); LayerNorm scale as weight
    assert state["embed.weight"].shape == (8, 5)
    assert state["block_1.qkv.weight"].shape == (24, 8)
    assert state["block_0.mlp_in.weight"].shape == (32, 8)
    np.testing.assert_array_equal(state["block_0.mlp_out.weight"].numpy(),
                                  np.asarray(params["block_0"]["mlp_out"]
                                             ["kernel"]).T)
    np.testing.assert_array_equal(state["ln_final.weight"].numpy(),
                                  np.asarray(params["ln_final"]["scale"]))
    path = str(tmp_path / "attn.npz")
    save_flax_npz({"params": params}, path)
    loaded = load_flax_npz(path)
    assert loaded.keys() == state.keys()
    port = build_model(ModelConfig(hidden_size=8, n_features=5, n_heads=2,
                                   n_layers=2, cell="attn"))
    port.load_state_dict(loaded, strict=True)


def test_init_is_seeded_and_shaped_like_flax():
    cfg = ModelConfig(hidden_size=16, n_features=40, cell="attn")
    a = build_model(cfg, generator=torch.Generator().manual_seed(7))
    b = build_model(cfg, generator=torch.Generator().manual_seed(7))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.embed.weight
    assert w.abs().max() <= 2 / np.sqrt(40) / 0.87962566103423978 + 1e-6
    assert abs(float(w.detach().std()) - 1 / np.sqrt(40)) < 0.02
    assert torch.equal(a.embed.bias, torch.zeros(16))
    assert torch.equal(a.block_0.ln_attn.weight, torch.ones(16))
    assert a.linear.weight.abs().max() <= 1 / np.sqrt(48)


def test_dropout_draws_from_the_generator():
    cfg = ModelConfig(hidden_size=8, n_features=6, n_heads=2, cell="attn",
                      dropout=0.5, attn_dropout=0.1)
    model = build_model(cfg).train()
    x = torch.randn(2, 5, 6, generator=torch.Generator().manual_seed(0))
    a = model(x, generator=torch.Generator().manual_seed(3))
    b = model(x, generator=torch.Generator().manual_seed(3))
    c = model(x, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert torch.equal(model(x), model(x))


def test_heads_must_divide_the_width_and_state_is_refused():
    with pytest.raises(ValueError, match="must divide hidden_size"):
        build_model(ModelConfig(hidden_size=10, n_features=3, n_heads=4,
                                cell="attn"))
    model = build_model(ModelConfig(hidden_size=8, n_features=3, n_heads=2,
                                    cell="attn"))
    x = torch.zeros(1, 4, 3)
    for kw in (dict(state=object()), dict(return_state=True)):
        with pytest.raises(ValueError, match="carries no state"):
            model(x, **kw)


@pytest.mark.parametrize("core", ["stream", "pool"])
def test_carried_state_serving_refuses_attn(core):
    """The window re-encode is the attn family's serving path."""
    cfg = ModelConfig(hidden_size=8, n_features=3, n_heads=2, cell="attn",
                      bidirectional=False)
    norm = NormParams(np.zeros(3, np.float32), np.ones(3, np.float32))
    with pytest.raises(ValueError, match="window-re-scan Predictor"):
        if core == "stream":
            StreamingBiGRU(cfg, {}, norm, window=2, device="cpu")
        else:
            SessionPool(cfg, {}, capacity=2, window=2, device="cpu")


# -- the config loader ---------------------------------------------------------


def _typos():
    """A misspelt section, then a misspelt key in each section."""
    cases = [({"modle": {}}, "unknown config sections")]
    for name in jax_config._SECTIONS:
        cases.append(({name: {"not_a_key": 1}},
                      rf"unknown keys in \[{name}\]"))
    cases.append(({"model": {"hiden_size": 64}}, r"unknown keys in \[model\]"))
    return cases


@pytest.mark.parametrize("data,match", _typos(),
                         ids=lambda v: json.dumps(v) if isinstance(v, dict)
                         else None)
def test_both_loaders_refuse_the_same_typos(data, match):
    with pytest.raises(ValueError, match=match):
        jax_config.config_from_dict(data)
    with pytest.raises(ValueError, match=match):
        config.config_from_dict(data)


def test_reference_key_table_is_the_reference_dataclasses():
    want = {name: tuple(f.name for f in dataclasses.fields(cls))
            for name, cls in jax_config._SECTIONS.items()}
    assert config.REFERENCE_KEYS == want
    # every section the port models takes a subset of the reference's keys
    for name, cls in config._SECTIONS.items():
        assert {f.name for f in dataclasses.fields(cls)} <= set(want[name])


def test_port_loads_every_reference_section_and_key():
    """A whole reference config file loads; the modeled keys are read."""
    ref = jax_config.FrameworkConfig(
        model=jax_config.ModelConfig(cell="attn", n_heads=8, attn_causal=True,
                                     attn_dropout=0.1, use_pallas=True),
        train=jax_config.TrainConfig(batch_size=64))
    data = json.loads(json.dumps(jax_config.config_to_dict(ref)))
    assert set(data) == set(config.REFERENCE_KEYS)
    cfg = config.config_from_dict(data)
    assert (cfg.model.cell, cfg.model.n_heads, cfg.model.attn_causal,
            cfg.model.attn_dropout) == ("attn", 8, True, 0.1)
    assert cfg.train.batch_size == 64
    assert cfg.model.n_features == ref.model.n_features == 108
    assert cfg.runtime.bucket_sizes == ref.runtime.bucket_sizes
    assert config.config_from_dict({}) == FrameworkConfig()
