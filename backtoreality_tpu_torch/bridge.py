"""Weights from the JAX package into the port.

`state_dict_from_jax` maps the JAX model's variables — the
``{"params": ..., "batch_stats": ...}`` tree as nested dicts of numpy
arrays, which ``jax.device_get`` or the JAX serialization's
``to_state_dict`` gives — onto the port's ``state_dict``. The port names
its submodules after the JAX module names, so the mapping is
mechanical:

* a Dense ``kernel`` (in, out) becomes ``nn.Linear.weight`` (out, in);
* a Dense or BatchNorm ``bias`` stays ``bias``;
* BatchNorm ``scale``, ``mean`` and ``var`` become ``weight``,
  ``running_mean`` and ``running_var``.
"""

from __future__ import annotations

import collections
import collections.abc

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, collections.abc.Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """JAX variables tree -> the port's state_dict (CPU tensors)."""
    out = collections.OrderedDict()
    for collection, leaves in (("params", _PARAM_LEAVES),
                               ("batch_stats", _STAT_LEAVES)):
        for path, value in _flatten(variables.get(collection, {})):
            *module, leaf = path
            if leaf not in leaves:
                raise KeyError(f"unmapped {collection} leaf"
                               f" {'/'.join(path)}")
            arr = np.asarray(value)
            if leaf == "kernel":
                arr = arr.T
            name = ".".join([*module, leaves[leaf]])
            out[name] = torch.from_numpy(np.array(arr, order="C"))
    return out
