"""Carry weights across from the JAX package, without JAX.

``fmda_tpu``'s BiGRU, BiLSTM and GatedSSM params are flax trees whose
recurrent leaves already carry the port's names and layouts
(``weight_ih_l0`` is (3H, F) or (4H, F), the SSM's per-channel
``a_base_l0``, ``d_l0``, ``rho_f_l0`` and ``rho_s_l0`` are (H,), and so
on), so they cross as they are.  The submodules cross by their paths
(``block_0/qkv`` becomes ``block_0.qkv``): a flax ``Dense`` (``kernel``,
``bias``) keeps its kernel as (in, out) where ``nn.Linear`` keeps (out,
in), so it is transposed; a flax ``LayerNorm``'s ``scale`` is
``nn.LayerNorm``'s ``weight``.  That covers the head ``linear`` of every
family and the TemporalTransformer's ``embed``, ``block_{i}/{ln_attn,
qkv, proj, ln_mlp, mlp_in, mlp_out}`` and ``ln_final``.
The tree arrives as nested dicts of numpy arrays
(``jax.device_get(params)``), or flattened into an ``.npz`` whose keys
join the tree's path with ``/``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _params_subtree(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _walk(tree: Mapping, prefix: str, state: Dict[str, np.ndarray]) -> None:
    for name, leaf in tree.items():
        path = prefix + name
        if not isinstance(leaf, Mapping):
            state[path] = np.array(leaf)
        elif "kernel" in leaf:  # Dense: (in, out) -> (out, in)
            state[f"{path}.weight"] = np.ascontiguousarray(
                np.asarray(leaf["kernel"]).T)
            state[f"{path}.bias"] = np.array(leaf["bias"])
        elif "scale" in leaf:  # LayerNorm
            state[f"{path}.weight"] = np.array(leaf["scale"])
            state[f"{path}.bias"] = np.array(leaf["bias"])
        else:
            _walk(leaf, path + ".", state)


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax BiGRU, BiLSTM, GatedSSM or TemporalTransformer ``params``
    tree (or ``{"params": ...}``) -> the port's ``state_dict``, which loads
    with ``strict=True``."""
    state: Dict[str, np.ndarray] = {}
    _walk(_params_subtree(tree), "", state)
    return {k: torch.from_numpy(v).to(torch.float32)
            for k, v in state.items()}


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> ``{"a/b/c": array}``, the ``.npz`` layout."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = np.asarray(value)
    return tree


def save_flax_npz(tree: Mapping, path: str) -> None:
    """Write a flax params tree (nested dicts of arrays) as an ``.npz``."""
    np.savez(path, **flatten_tree(tree))


def load_flax_npz(path: str) -> Dict[str, torch.Tensor]:
    """Read a flattened flax params tree and return the port's
    ``state_dict``."""
    with np.load(path) as data:
        return params_from_flax(unflatten_tree({k: data[k] for k in data}))
