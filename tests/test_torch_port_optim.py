"""The port's fused three-group optimizer (sug_tpu_torch/engine/optim.py)
against sug_tpu.engine.optim on the CPU: three updates fed identical
gradients, then the new parameters and all three groups' Adam moments of
every leaf to 1e-6 (both compute the same f32 elementwise formula; they
differ by an ulp in the bias correction's power and in fused adds). Also the
group masks on NetMDA's real parameter names, and the two learning-rate
schedules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from sug_tpu.engine import optim as jo
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu_torch.engine import optim as to
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.utils.jax_bridge import torch_key

TOL = dict(rtol=1e-6, atol=1e-7)

# leaves covering every group and the exclusions: generator (with and
# without pred_offset), BN scales, heads, attention layers
SHAPES = {
    ("g", "block1", "conv_dense", "kernel"): (6, 4),
    ("g", "block1", "bn_scale"): (4,),
    ("g", "sa_node", "pred_offset", "kernel"): (4, 3),
    ("g", "bn5", "scale"): (5,),
    ("c1", "mlp1", "Dense_0", "kernel"): (5, 3),
    ("c1", "mlp1", "LayerNorm_0", "scale"): (3,),
    ("c2", "mlp3", "bias"): (3,),
    ("attention_s", "Dense_0", "kernel"): (4, 2),
    ("attention_t", "BatchNorm_0", "bias"): (4,),
}


def _tree(rng):
    return unflatten_dict({k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()})


def _torch_view(flat):
    """name -> torch layout of a flat JAX tree (Dense kernels transposed)."""
    return {torch_key(k): (v.T if k[-1] == "kernel" else v) for k, v in flat.items()}


def test_three_updates_match_optax():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    lrs = [(1e-3, 2e-3, 5e-4), (8e-4, 8e-4, 5e-4), (3e-3, 1e-3, 2.5e-4)]
    wd = 5e-4

    jopt = jo.ThreeGroupOptimizer(params, wd)
    jstate, jparams = jopt.init(params), jax.tree.map(jnp.asarray, params)
    update = jax.jit(jopt.update)
    for g, (lg, lc, ld) in zip(grads, lrs):
        jparams, jstate = update(jax.tree.map(jnp.asarray, g), jstate, jparams, lg, lc, ld)

    flat_p = _torch_view(flatten_dict(params))
    names = sorted(flat_p)
    tparams = [torch.tensor(flat_p[n]) for n in names]
    topt = to.ThreeGroupOptimizer(list(zip(names, tparams)), wd)
    for g, (lg, lc, ld) in zip(grads, lrs):
        flat_g = _torch_view(flatten_dict(g))
        topt.update([torch.tensor(flat_g[n]) for n in names], lg, lc, ld)

    want_p = _torch_view(flatten_dict(jax.tree.map(np.asarray, jparams)))
    for n, p in zip(names, tparams):
        np.testing.assert_allclose(p.numpy(), want_p[n], err_msg=n, **TOL)
    for group in to.GROUPS:
        adam = getattr(jstate, group)[1]
        assert int(adam.count) == topt.state[group]["count"] == 3
        for key in ("mu", "nu"):
            want = _torch_view(flatten_dict(jax.tree.map(np.asarray, getattr(adam, key))))
            for n, m in zip(names, topt.state[group][key]):
                np.testing.assert_allclose(m.numpy(), want[n], err_msg=f"{group}/{key}/{n}", **TOL)


def test_group_masks_on_net_mda_names():
    jm = JNetMDA(model_name="DGCNN", num_class=10)
    variables = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 64, 3)), True, domain="both"))
    jmasks = {g: {torch_key(k): v for k, v in flatten_dict(m).items()}
              for g, m in jo.param_group_masks(variables["params"]).items()}
    names = [n for n, _ in NetMDA("DGCNN").named_parameters()]
    tmasks = to.param_group_masks(names)
    for group in to.GROUPS:
        assert dict(zip(names, tmasks[group])) == jmasks[group], group
    assert not dict(zip(names, tmasks["g"]))["g.sa_node.pred_offset.weight"]
    assert dict(zip(names, tmasks["dis"]))["g.sa_node.pred_offset.weight"]


def test_optimizer_state_round_trip():
    p = torch.nn.Parameter(torch.ones(3))
    opt = to.ThreeGroupOptimizer([("g.w", p)], 0.0)
    opt.update([torch.full((3,), 0.5)], 1e-3, 1e-3, 1e-3)
    fresh = to.ThreeGroupOptimizer([("g.w", torch.nn.Parameter(torch.ones(3)))], 0.0)
    fresh.load_state_dict(opt.state_dict())
    for group in to.GROUPS:
        assert fresh.state[group]["count"] == 1
        assert torch.equal(fresh.state[group]["mu"][0], opt.state[group]["mu"][0])
    with pytest.raises(KeyError):
        to.ThreeGroupOptimizer([("g.other", p)], 0.0).load_state_dict(opt.state_dict())


@pytest.mark.parametrize("epoch", [0, 1, 4, 5, 12, 30, 31, 45, 199])
def test_lr_schedules(epoch):
    assert to.cosine_lr(1e-4, epoch, 200) == jo.cosine_lr(1e-4, epoch, 200)
    assert to.dis_lr_schedule(1e-4, 2.0, epoch) == jo.dis_lr_schedule(1e-4, 2.0, epoch)
