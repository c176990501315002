"""Carry weights across from the JAX package, without JAX.

``fmda_tpu``'s BiGRU and BiLSTM params are flax trees whose recurrent
leaves already use ``nn.GRU``'s and ``nn.LSTM``'s names and layouts
(``weight_ih_l0`` is (3H, F) or (4H, F), and so on); only the head differs: flax's ``Dense`` keeps its kernel as (in, out),
``nn.Linear`` its weight as (out, in).  The tree arrives as nested dicts
of numpy arrays (``jax.device_get(params)``), or flattened into an
``.npz`` whose keys join the tree's path with ``/``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _params_subtree(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax BiGRU or BiLSTM ``params`` tree (or ``{"params": ...}``) ->
    the port's ``state_dict``, which loads with ``strict=True``."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _params_subtree(tree).items():
        if name == "linear":
            state["linear.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(leaf["kernel"]).T))
            state["linear.bias"] = torch.from_numpy(np.array(leaf["bias"]))
        else:
            state[name] = torch.from_numpy(np.array(leaf))
    return {k: v.to(torch.float32) for k, v in state.items()}


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
