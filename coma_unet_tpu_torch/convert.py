"""Parameter bridge from the JAX package's flax parameter tree.

`from_flax(params, module)` maps the flax `params` tree (nested mappings of
arrays, e.g. `variables["params"]` after `jax.device_get`) onto `module`'s
state dict: the key is the flax path joined with ".", Dense kernels
`[in, out]` become `Linear.weight [out, in]`, and every other leaf (conv and
expert kernels, biases, prompts, PReLU slopes) maps unchanged. The bridge is
strict: a flax leaf with no port parameter, a port parameter with no flax
leaf, or a shape that differs raises ValueError.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, value in tree.items():
        path = prefix + (str(name),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _port_key(path: Tuple[str, ...], value: np.ndarray):
    if path[-1] == "kernel" and value.ndim == 2:  # flax Dense
        return ".".join(path[:-1] + ("weight",)), value.T
    return ".".join(path), value


def from_flax(params: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """State dict for `module` from the flax parameter tree `params`."""
    target = module.state_dict()
    state: Dict[str, torch.Tensor] = {}
    extra = []
    for path, value in _leaves(params):
        key, value = _port_key(path, value)
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
        raise ValueError(f"flax leaves with no port parameter: {extra}; "
                         f"port parameters with no flax leaf: {missing}")
    return state
