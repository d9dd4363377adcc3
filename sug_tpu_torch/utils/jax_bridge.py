"""Carry the JAX package's weights into the port.

``state_dict_from_jax(variables)`` takes the ``{"params", "batch_stats"}``
tree of ``sug_tpu``'s ``NetMDA`` (DGCNN, PTran, Pointnet, Pointnet2 or
KPConv) or of one of its standalone classifiers (``make_classifier``: the
same five), as nested dicts of numpy arrays, and returns the port's
``state_dict``. The port's modules are named after the JAX tree (PTran's
``g/backbone/transformer1/w_qs``,
``g/backbone/td0/mlp0/Dense_0``, ``g/point_mix``; PointNet's
``g/trans_net1/ConvBN_0``, ``g/conv1`` ... ``g/conv5``, ``g/bn1``,
``g/sa_node``; PointNet++'s ``g/sa1/mlp0``, the classifier's ``fc1``
and ``BatchNorm_1``; KPConv's ``g/encoder/block1/unary1/Dense_0``,
``g/encoder/block1/KPConv`` and a deformable op's
``.../KPConv/offset_conv`` and ``.../KPConv/offset_bias``), so the bridge
is a rename plus a transpose:

- module path: kept, with flax's auto-names renamed (``AUTONAMES``);
- leaf: ``kernel`` -> ``weight`` (flax Dense ``(in, out)`` transposed to
  torch Linear ``(out, in)``), ``scale`` -> ``weight``, ``mean`` ->
  ``running_mean``, ``var`` -> ``running_var``; other names are kept, and
  their arrays as they are (KPConv's ``weights``, (K, Cin, Cout) in both).

``load_jax_variables`` loads the result strictly: a JAX leaf the model does
not have, or a model tensor no leaf fills, raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

COLLECTIONS = ("params", "batch_stats")
AUTONAMES = {"Dense_0": "dense0", "Dense_1": "dense1", "BatchNorm_0": "bn", "BatchNorm_1": "bn1",
             "LayerNorm_0": "ln", "ConvBN_0": "convbn0", "ConvBN_1": "convbn1", "ConvBN_2": "convbn2",
             "FCLayer_0": "fc0", "FCLayer_1": "fc1"}
LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}


def torch_key(path: Tuple[str, ...]) -> str:
    """The port's state_dict key for a JAX leaf path (collection excluded)."""
    *modules, leaf = path
    return ".".join([AUTONAMES.get(m, m) for m in modules] + [LEAVES.get(leaf, leaf)])


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, prefix + (str(name),))
        else:
            yield prefix + (str(name),), sub


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state_dict for a JAX variable tree; every leaf is used."""
    extra = set(variables) - set(COLLECTIONS)
    if extra:
        raise KeyError(f"unexpected JAX variable collections {sorted(extra)}")
    out: Dict[str, torch.Tensor] = {}
    for collection in COLLECTIONS:
        for path, leaf in _leaves(variables.get(collection, {})):
            key = torch_key(path)
            if key in out:
                raise KeyError(f"two JAX leaves map to {key!r} (second: {collection}/{'/'.join(path)})")
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.T
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_jax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fill every tensor of ``model`` from a JAX variable tree; leftovers on
    either side raise."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)


def unflatten(flat: Mapping[str, object], sep: str = "/") -> Dict:
    """Nest ``{"params/g/block1/bn_scale": array, ...}`` (an ``.npz`` written
    with ``flax.traverse_util.flatten_dict(..., sep="/")``) into dicts."""
    tree: Dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split(sep)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree
