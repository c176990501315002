"""fmda_tpu_torch's BiGRU and BiLSTM against the JAX package's, on the CPU.

The JAX model (``cell="gru"`` or ``"lstm"``) is initialised from a seed,
its flax params cross-load through ``params_from_flax``, and numpy-seeded
windows go through both in eval mode (dropout off: the two frameworks'
random bits cannot match).  Tolerance 1e-5 on float32 logits.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fmda_tpu.config import FrameworkConfig as JaxFrameworkConfig
from fmda_tpu.config import ModelConfig as JaxModelConfig
from fmda_tpu.models import build_model as jax_build_model

from fmda_tpu_torch.config import FrameworkConfig, ModelConfig
from fmda_tpu_torch.interop import load_flax_npz, params_from_flax, save_flax_npz
from fmda_tpu_torch.models import BiGRU, BiLSTM, build_model

TOL = 1e-5
CELLS = ["gru", "lstm"]


def _jax_params(cfg, seed=0, steps=7):
    model = jax_build_model(cfg)
    params = model.init({"params": jax.random.PRNGKey(seed)},
                        jnp.zeros((1, steps, cfg.n_features)))["params"]
    return model, jax.device_get(params)


def _port_model(cfg: ModelConfig, flax_params):
    model = build_model(cfg)
    assert type(model) is {"gru": BiGRU, "lstm": BiLSTM}[cfg.cell]
    model.load_state_dict(params_from_flax(flax_params), strict=True)
    return model.eval()


def _ragged_mask(batch, steps, seed=5):
    lengths = np.random.default_rng(seed).integers(1, steps + 1, size=batch)
    return np.arange(steps)[None, :] < lengths[:, None]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_bigru_logits_match_jax(n_layers, bidirectional, masked, cell):
    fields = dict(hidden_size=5, n_features=6, output_size=4,
                  n_layers=n_layers, bidirectional=bidirectional, cell=cell)
    jax_model, params = _jax_params(JaxModelConfig(**fields))
    port = _port_model(ModelConfig(**fields), params)
    r = np.random.default_rng(n_layers * 10 + bidirectional)
    x = r.normal(size=(3, 7, 6)).astype(np.float32)
    mask = _ragged_mask(3, 7) if masked else None
    want = jax_model.apply({"params": params}, x,
                           mask=None if mask is None else jnp.asarray(mask))
    with torch.inference_mode():
        got = port(torch.from_numpy(x),
                   mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("cell", CELLS)
def test_full_width_default_config_matches_jax(cell):
    jax_cfg = dataclasses.replace(JaxFrameworkConfig().model, cell=cell)
    cfg = dataclasses.replace(FrameworkConfig().model, cell=cell)
    assert (cfg.hidden_size, cfg.n_features, cfg.n_layers,
            cfg.bidirectional) == (32, 108, 1, True)
    assert cfg.hidden_size == jax_cfg.hidden_size
    assert cfg.n_features == jax_cfg.n_features
    jax_model, params = _jax_params(jax_cfg, seed=1, steps=30)
    port = _port_model(cfg, params)
    x = np.random.default_rng(6).normal(size=(4, 30, 108)).astype(np.float32)
    want = jax_model.apply({"params": params}, x)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("cell", CELLS)
def test_load_flax_npz_round_trip(tmp_path, cell):
    cfg = JaxModelConfig(hidden_size=4, n_features=3, n_layers=2, cell=cell)
    _, params = _jax_params(cfg)
    path = str(tmp_path / "params.npz")
    save_flax_npz({"params": params}, path)
    loaded = load_flax_npz(path)
    direct = params_from_flax(params)
    assert loaded.keys() == direct.keys()
    for k in direct:
        assert torch.equal(loaded[k], direct[k])
    # the head's (in, out) flax kernel arrives as nn.Linear's (out, in)
    assert loaded["linear.weight"].shape == (cfg.output_size, 3 * 4)
    port = build_model(ModelConfig(hidden_size=4, n_features=3, n_layers=2,
                                   cell=cell))
    port.load_state_dict(loaded, strict=True)


@pytest.mark.parametrize("cell", CELLS)
def test_parameter_names_follow_nn_gru(cell):
    port = build_model(ModelConfig(hidden_size=4, n_features=3, n_layers=2,
                                   cell=cell))
    module = {"gru": torch.nn.GRU, "lstm": torch.nn.LSTM}[cell]
    reference = module(3, 4, num_layers=2, bidirectional=True)
    names = {k for k in port.state_dict() if not k.startswith("linear.")}
    assert names == set(reference.state_dict())
    for k, v in reference.state_dict().items():  # gate rows stacked alike
        assert port.state_dict()[k].shape == v.shape, k


@pytest.mark.parametrize("cell", CELLS)
def test_init_is_seeded_and_uniform_in_fan(cell):
    cfg = ModelConfig(hidden_size=16, n_features=3, cell=cell)
    a = build_model(cfg, generator=torch.Generator().manual_seed(7))
    b = build_model(cfg, generator=torch.Generator().manual_seed(7))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        fan = 3 * 16 if name.startswith("linear.") else 16
        assert p.abs().max() <= 1.0 / np.sqrt(fan)


def test_spatial_dropout_drops_whole_channels_from_the_generator():
    cfg = ModelConfig(hidden_size=4, n_features=6, dropout=0.5)
    from fmda_tpu_torch.models.common import dropout

    x = torch.ones(3, 5, 6)
    a = dropout(x, 0.5, training=True, spatial=True,
                generator=torch.Generator().manual_seed(3))
    b = dropout(x, 0.5, training=True, spatial=True,
                generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    # one keep mask per (B, F), the same at every step
    assert torch.equal(a, a[:, :1].expand_as(a))
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    model = build_model(cfg).eval()
    with torch.inference_mode():  # eval mode: dropout is off
        assert torch.equal(model(x), model(x))


@pytest.mark.parametrize("cell", ["rnn"])
def test_other_cells_are_not_ported(cell):
    # every family of the reference is ported: an unknown cell is refused
    # with the reference's wording
    with pytest.raises(ValueError, match="unknown ModelConfig.cell"):
        ModelConfig(cell=cell)
    # a config object that did not come through ModelConfig's own check
    with pytest.raises(ValueError, match="unknown ModelConfig.cell"):
        build_model(types.SimpleNamespace(cell=cell))
