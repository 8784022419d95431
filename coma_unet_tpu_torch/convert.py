"""Parameter bridge from the JAX package's flax variable trees.

`from_flax(params, module, batch_stats=None)` maps the flax `params` tree
(nested mappings of arrays, e.g. `variables["params"]` after
`jax.device_get`) and, for a model with batch norm, its `batch_stats`
tree onto `module`'s state dict. The key is the flax path joined with ".":
  * Dense kernels `[in, out]` become `Linear.weight [out, in]`;
  * the attention's DenseGeneral kernels, query / key / value
    `[d, heads, head_dim]` and out `[heads, head_dim, d]`, become
    `Linear.weight [heads*head_dim, d]` and `[d, heads*head_dim]`, and
    the query / key / value biases `[heads, head_dim]` are flattened;
  * a LayerNorm's `scale` becomes its `weight`;
  * batch norm's `batch_stats` leaves `mean` and `var` become the buffers
    of the same path;
  * every other leaf (conv and expert kernels, biases, prompts, position
    embeddings and bias tables, PReLU slopes, batch norm's `scale`) maps
    unchanged.
The bridge is strict: a flax leaf with no port entry, a port entry with no
flax leaf, or a shape that differs raises ValueError. Non-persistent
buffers (the Swin index and mask tables) are outside the state dict.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

_QKV = ("query", "key", "value")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, value in tree.items():
        path = prefix + (str(name),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _port_key(path: Tuple[str, ...], value: np.ndarray, target: Mapping):
    leaf, owner = path[-1], path[-2] if len(path) > 1 else ""
    key = ".".join(path)
    if leaf == "kernel" and value.ndim == 2:  # flax Dense
        return ".".join(path[:-1] + ("weight",)), value.T
    if leaf == "kernel" and value.ndim == 3 and owner in _QKV:
        d = value.shape[0]
        return ".".join(path[:-1] + ("weight",)), value.reshape(d, -1).T
    if leaf == "kernel" and value.ndim == 3 and owner == "out":
        d = value.shape[-1]
        return ".".join(path[:-1] + ("weight",)), value.reshape(-1, d).T
    if leaf == "bias" and value.ndim == 2 and owner in _QKV:
        return key, value.reshape(-1)
    if leaf == "scale" and key not in target:  # LayerNorm
        return ".".join(path[:-1] + ("weight",)), value
    return key, value


def from_flax(params: Mapping, module: nn.Module,
              batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """State dict for `module` from the flax trees `params` and, where
    the model has batch norm, `batch_stats`."""
    target = module.state_dict()
    state: Dict[str, torch.Tensor] = {}
    extra = []
    leaves = list(_leaves(params))
    if batch_stats:
        leaves += list(_leaves(batch_stats))
    for path, value in leaves:
        key, value = _port_key(path, value, target)
        if key not in target:
            extra.append(key)
            continue
        want = tuple(target[key].shape)
        if tuple(value.shape) != want:
            raise ValueError(f"{key}: flax shape {tuple(value.shape)}, "
                             f"port shape {want}")
        state[key] = torch.from_numpy(np.array(value)).to(
            target[key].dtype)
    missing = sorted(set(target) - set(state))
    if extra or missing:
        raise ValueError(f"flax leaves with no port entry: {extra}; "
                         f"port entries with no flax leaf: {missing}")
    return state
