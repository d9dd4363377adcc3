"""Shared helpers for the tests that hold ``sug_tpu_torch`` against
``sug_tpu`` on the CPU: JAX variable trees with randomised BN statistics and
signed BN scales (flax init sets every scale to 1, which never reaches the
``amin`` branch of the EdgeConv epilogue), and loading them into the port."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sug_tpu_torch.utils.jax_bridge import load_jax_variables, state_dict_from_jax


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


def jax_grads_by_name(param_grads):
    """A JAX ``params`` gradient tree as the port's parameter names (Dense
    kernels transposed to the torch layout), as numpy."""
    return {k: v.numpy() for k, v in state_dict_from_jax({"params": to_numpy_tree(param_grads)}).items()}


def jax_stats_by_name(batch_stats):
    """A JAX ``batch_stats`` tree as the port's buffer names, as numpy."""
    return {k: v.numpy() for k, v in state_dict_from_jax({"batch_stats": to_numpy_tree(batch_stats)}).items()}


def assert_leaves_close(got, want, rtol=1e-4, atol_frac=1e-4):
    """Every leaf of ``want`` (name -> array) against ``got``: ``rtol``
    relative, and ``atol_frac`` of the leaf's largest |value| absolute, or of
    1e-2 of the largest |value| of all leaves where that is larger.
    Gradients and statistics are sums whose rounding scales with their
    terms; a leaf whose true value is zero (a Dense bias before a train-mode
    BN) holds only that rounding."""
    assert set(got) == set(want), set(got) ^ set(want)
    floor = 1e-2 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = np.asarray(got[name])
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_frac * max(np.abs(w).max(), floor),
                                   err_msg=name)


def assert_rel_l2(got, want, bound):
    """Every leaf of ``want`` against ``got`` in relative L2 error,
    ``|g - w| / max(|w|, 1e-2 of the largest leaf's |w|)``: a leaf whose
    true value is zero (a bias before a train-mode BN) holds only rounding."""
    assert set(got) == set(want), set(got) ^ set(want)
    floor = 1e-2 * max(np.linalg.norm(w) for w in want.values())
    worst = {}
    for name, w in want.items():
        g = np.asarray(got[name], dtype=np.float64)
        worst[name] = np.linalg.norm(g - w) / max(np.linalg.norm(w), floor)
    name = max(worst, key=worst.get)
    print(f"largest relative L2 error: {worst[name]:.3e} ({name})")
    assert worst[name] <= bound, (name, worst[name])


def port_weights_as_jax(jmodel, port_state, *init_args, seed: int = 5, **init_kwargs):
    """A JAX variable tree of ``jmodel`` filled from a port ``state_dict``
    (the tree's shapes from tracing the JAX init, which spares compiling
    it), then randomised (``randomize_variables`` with ``seed``). Only the
    params and BN statistics: a deformable KPConv's init also returns the
    ``regularizers`` it sows."""
    from sug_tpu_torch.utils.jax_bridge import COLLECTIONS, torch_key

    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, *init_args, **init_kwargs))
    shapes = {k: v for k, v in shapes.items() if k in COLLECTIONS}

    def leaf(path, shape):
        names = tuple(k.key for k in path)
        value = port_state[torch_key(names[1:])].numpy()
        value = value.T if names[-1] == "kernel" else value
        assert value.shape == shape.shape, names
        return value

    return randomize_variables(jax.tree_util.tree_map_with_path(leaf, dict(shapes)), seed=seed)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a test module's PyTorch on one CPU thread, then restore the
    count. These modules run many small ops at B=4..8, N=128; with one
    intra-op pool per pytest worker (tier-1 runs six) the pools oversubscribe
    the cores, and such ops then take tens of times longer than alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
