"""Shared helpers for the tests that hold ``sug_tpu_torch`` against
``sug_tpu`` on the CPU: JAX variable trees with randomised BN statistics and
signed BN scales (flax init sets every scale to 1, which never reaches the
``amin`` branch of the EdgeConv epilogue), and loading them into the port."""

from __future__ import annotations

import jax
import numpy as np
import torch

from sug_tpu_torch.utils.jax_bridge import load_jax_variables


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def randomize_variables(variables, seed: int = 0):
    """Numpy copy of a flax variable tree with random BN running stats, BN
    scales of random sign (about a third negative) and random biases."""
    rng = np.random.default_rng(seed)
    out = to_numpy_tree(jax.device_get(variables))

    def visit(tree, path):
        for name, sub in tree.items():
            if isinstance(sub, dict):
                visit(sub, path + (name,))
                continue
            shape = sub.shape
            is_ln = any(p.startswith("LayerNorm") for p in path)
            if name in ("mean", "bn_mean"):
                tree[name] = rng.normal(0.0, 0.2, shape).astype(np.float32)
            elif name in ("var", "bn_var"):
                tree[name] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
            elif name in ("scale", "bn_scale") and not is_ln:
                sign = np.where(rng.uniform(size=shape) < 0.35, -1.0, 1.0)
                tree[name] = (sign * rng.uniform(0.5, 1.5, shape)).astype(np.float32)
            elif name in ("bias", "bn_bias"):
                tree[name] = rng.normal(0.0, 0.1, shape).astype(np.float32)

    visit(out, ())
    return out


def port_module(module: torch.nn.Module, variables) -> torch.nn.Module:
    """``module`` in eval mode with every tensor filled from ``variables``."""
    load_jax_variables(module, variables)
    return module.eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))
