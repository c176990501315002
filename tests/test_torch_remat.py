"""``model.remat`` in fmda_tpu_torch, as ``fmda_tpu`` reads it: each attn
encoder block (``nn.remat`` in ``fmda_tpu.models.attn``) and the gru and
lstm plain scans (``jax.checkpoint`` in ``fmda_tpu.ops.gru``/``lstm``) are
recomputed in the backward pass.  The gradients must not move: bit-equal
at dropout 0, and within 1e-6 with dropout on, where the recompute has to
draw the same masks from the generator the forward drew them from (the
checkpoint restores the global RNG streams, not a generator passed in),
and the generator must end in the same state."""

import dataclasses

import pytest
import torch

from fmda_tpu.config import config_from_dict as jax_config_from_dict

from fmda_tpu_torch.config import ModelConfig, config_from_dict
from fmda_tpu_torch.models import build_model

#: dropout on: the same masks give the same float ops, so any difference
#: is a mask drawn apart
DROPOUT_TOL = 1e-6
CELLS = ["attn", "gru", "lstm"]


def _grads(cfg, *, remat, seed=0):
    """Parameter gradients of one training-mode forward and backward, and
    the dropout generator's state after it."""
    generator = torch.Generator().manual_seed(seed)
    model = build_model(dataclasses.replace(cfg, remat=remat),
                        generator=torch.Generator().manual_seed(1))
    model.train()
    x = torch.randn(4, 7, cfg.n_features,
                    generator=torch.Generator().manual_seed(2))
    mask = torch.ones(4, 7)
    mask[1, :2] = 0.0
    logits = model(x, mask, generator=generator)
    (logits.square().sum() + logits.sum()).backward()
    return ({k: p.grad.clone() for k, p in model.named_parameters()},
            generator.get_state())


def _cfg(cell, dropout):
    return ModelConfig(cell=cell, n_features=6, hidden_size=8, n_layers=2,
                       n_heads=2, dropout=dropout,
                       bidirectional=cell != "attn")


@pytest.mark.parametrize("cell", CELLS)
def test_remat_gradients_bit_equal_at_dropout_zero(cell):
    plain, _ = _grads(_cfg(cell, 0.0), remat=False)
    rematted, _ = _grads(_cfg(cell, 0.0), remat=True)
    assert plain.keys() == rematted.keys()
    for name in plain:
        assert torch.equal(plain[name], rematted[name]), name


@pytest.mark.parametrize("cell", CELLS)
def test_remat_keeps_the_generators_dropout_masks(cell):
    plain, plain_state = _grads(_cfg(cell, 0.3), remat=False)
    rematted, remat_state = _grads(_cfg(cell, 0.3), remat=True)
    err = max(float((plain[k] - rematted[k]).abs().max()) for k in plain)
    assert err <= DROPOUT_TOL
    assert torch.equal(plain_state, remat_state)


def test_remat_recomputes_in_the_backward():
    """The attn block runs twice under remat (forward and the backward's
    recompute), once without; the recomputed pass draws its masks again
    from the snapshot, so the generator's state after the backward is the
    one the forward left."""
    cfg = _cfg("attn", 0.3)
    calls = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            generator=torch.Generator().manual_seed(1))
        model.train()
        n = [0]
        model.block_0.register_forward_pre_hook(
            lambda *_: n.__setitem__(0, n[0] + 1))
        generator = torch.Generator().manual_seed(0)
        out = model(torch.randn(2, 5, 6), generator=generator)
        after_forward = generator.get_state()
        out.sum().backward()
        assert torch.equal(generator.get_state(), after_forward)
        calls[remat] = n[0]
    assert calls == {False: 1, True: 2}


def test_remat_off_the_tape_runs_plainly():
    """Under no_grad (serving) remat changes nothing and checkpoints
    nothing: the logits are the plain model's bits."""
    cfg = _cfg("attn", 0.0)
    x = torch.randn(3, 5, 6)
    outs = []
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            outs.append(model.eval()(x))
    assert torch.equal(outs[0], outs[1])


def test_config_reads_remat_as_the_reference():
    data = {"model": {"remat": True, "cell": "attn"}}
    cfg = config_from_dict(data)
    assert cfg.model.remat is True
    assert jax_config_from_dict(data).model.remat is cfg.model.remat
    assert config_from_dict({}).model.remat is False
    assert ModelConfig().remat is False
