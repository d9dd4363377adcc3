"""Loading checkpoints of the reference PyTorch repo into the port
(``sug_tpu_torch/utils/torch_convert.py``, the entry point
``sug_tpu_torch/convert_reference_checkpoint.py``) against the JAX package's
converter (``sug_tpu/utils/torch_convert.py``) on the CPU. No reference
checkpoint is needed: ``synthetic_reference_state_dict`` makes a seeded one
under the reference's key names for Pointnet, DGCNN, Pointnet2 and PTran
(every BN statistic random, ``num_batches_tracked`` and the dead
parameters included).

1. Its shapes are checked, not assumed: the JAX converter turns it into
   exactly the tree and the shapes of the JAX ``NetMDA(model_name)``'s
   variables.
2. The port's ``convert_net_mda`` equals the JAX converter's result carried
   through ``utils/jax_bridge.py``, key for key and bit for bit, and the
   port's ``NetMDA`` loads it strictly. A wrong transpose of ``NODE_PERM``
   would still load; only this comparison catches it.
3. For Pointnet and Pointnet2 at B=2, the port model's logits against the
   JAX ``NetMDA.apply`` of the JAX-converted variables, to 1e-4 abs + 1e-4
   rel (the eval forwards' tolerance of ``tests/test_torch_port_pointnet.py``).
4. ``load_reference_checkpoint`` on ``.pth`` files written by ``torch.save``:
   raw, wrapped under ``model_state``, ``state_dict`` or ``model``, under an
   explicit ``key``, and with DataParallel's ``module.`` prefix.
5. The entry point's ``.pt`` for each backbone it takes, served by ``infer
   --dg --device cpu``: the logits of the converted model.
6. KPConv and an unknown name raise ``NotImplementedError``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu.utils import torch_convert as jtc
from sug_tpu_torch import convert_reference_checkpoint, infer
from sug_tpu_torch.data.datasets import PointCloudDataset
from sug_tpu_torch.models.net_mda import NetMDA, ensemble_logits
from sug_tpu_torch.utils import torch_convert as tc
from sug_tpu_torch.utils.jax_bridge import state_dict_from_jax
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

N = 1024
TOL = dict(rtol=1e-4, atol=1e-4)
MODELS = ("Pointnet", "DGCNN", "Pointnet2", "PTran")
CLI_MODELS = ("Pointnet", "DGCNN", "Pointnet2")
WRAPS = ("raw", "model_state", "state_dict", "model", "key", "module")


def _clouds(seed, b=2):
    rng = np.random.default_rng(seed)
    pc = rng.uniform(-1, 1, size=(b, N, 3)) * rng.uniform(0.3, 1.0, size=(b, 1, 3))
    return (pc / np.linalg.norm(pc, axis=-1).max(-1)[:, None, None]).astype(np.float32)


@pytest.fixture(scope="module", params=MODELS)
def converted(request):
    """(name, the synthetic reference state dict, the JAX converter's variables)."""
    name = request.param
    sd = tc.synthetic_reference_state_dict(name, seed=MODELS.index(name))
    return name, sd, jtc.convert_net_mda(sd, name)


def test_jax_converter_confirms_the_shapes(converted):
    name, _, variables = converted
    shapes = jax.eval_shape(lambda: JNetMDA(model_name=name).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jnp.zeros((2, N, 3)), False,
        domain="both"))
    want = {k: v.shape for k, v in flatten_dict(dict(shapes)).items()}
    got = {k: np.shape(v) for k, v in flatten_dict(variables).items()}
    assert got == want


def test_port_converter_bit_for_bit(converted):
    name, sd, variables = converted
    got = tc.convert_net_mda(sd, name)
    want = state_dict_from_jax(variables)
    assert list(sorted(got)) == list(sorted(want))
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert torch.equal(got[k], w), k
    NetMDA(name).load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", ["Pointnet", "Pointnet2"])
def test_logits_match_jax(name):
    sd = tc.synthetic_reference_state_dict(name, seed=MODELS.index(name))
    variables = jtc.convert_net_mda(sd, name)
    pc = _clouds(1)
    jm = JNetMDA(model_name=name)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(pc))
    model = NetMDA(name)
    model.load_state_dict(tc.convert_net_mda(sd, name), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(pc))
    for k in ("logits1", "logits2", "global_feat", "node_flat"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("wrap", WRAPS)
def test_load_reference_checkpoint(wrap, tmp_path):
    sd = tc.synthetic_reference_state_dict("Pointnet2", seed=7)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    key = None
    if wrap == "key":
        key, blob = "weights", {"weights": tensors, "epoch": 12}
    elif wrap == "module":
        blob = {f"module.{k}": v for k, v in tensors.items()}
    elif wrap == "raw":
        blob = tensors
    else:
        blob = {wrap: tensors, "epoch": 12, "best_acc": 0.5}
    path = tmp_path / "model.pth"
    torch.save(blob, path)
    got = tc.load_reference_checkpoint(str(path), "Pointnet2", key=key)
    want = tc.convert_net_mda(sd, "Pointnet2")
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("name", CLI_MODELS)
def test_cli_checkpoint_served_by_infer(name, tmp_path, capsys):
    sd = tc.synthetic_reference_state_dict(name, seed=11)
    pth, pt, pts = tmp_path / "ref.pth", tmp_path / "port.pt", tmp_path / "clouds.npy"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pth)
    convert_reference_checkpoint.main(["--ckpt", str(pth), "--model", name, "--out", str(pt)])
    state = tc.convert_net_mda(sd, name)
    assert f"{sum(v.numel() for v in state.values()):,} parameters ({name})" in capsys.readouterr().out
    pc = _clouds(2, b=3)
    np.save(pts, pc)
    result = infer.main(["--ckpt", str(pt), "--model", name, "--dg", "--pts", str(pts),
                         "--device", "cpu", "--num_points", str(N)])
    model = NetMDA(name)
    model.load_state_dict(state, strict=True)
    served = infer.load_model(name, str(pt), torch.device("cpu"), N)
    ingested = torch.from_numpy(PointCloudDataset("modelnet", pc, np.zeros(3), num_points=N).pts)
    with torch.no_grad():
        want = ensemble_logits(model.eval(), ingested)
        got = ensemble_logits(served, ingested)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(result["preds"], torch.argmax(want, -1).numpy())


@pytest.mark.parametrize("name,match", [("KPConv", "by design"), ("Pointnet3", "no converter")])
def test_unconvertible_models_raise(name, match):
    with pytest.raises(NotImplementedError, match=match):
        tc.convert_net_mda({}, name)
