"""KPConv's FPS pyramid and the slice's configuration (the shipped
``DG_unified_loss_onedataset_modelnet_KPConv.yaml`` with ``pyramid: fps``
and every block after the third strided one deformable, ``SLICE_YAML``)
in the port against the JAX package on the CPU:

1. ``build_pyramid`` on the FPS pyramid against the JAX one from the same
   starts, at 512 and 520 points: every level's points equal, neighbour and
   pool queries equal off radius ties, no masks, no gradient;
2. the mask-free forms: ``instance_norm`` (the population variance),
   ``_masked_mean`` and ``_sample_tensor_slices`` (at 130 tap rows, where
   the masked form with an all-ones mask takes other rows from the 33rd on,
   and at 32, where the JAX slice yields 32 rows);
3. ``check_neighbor_occupancy`` on the FPS pyramid;
4. the generator at narrow widths (``NET_CFG``: six blocks, three
   deformable and modulated, ``first_feats_dim`` 16), its global and node
   features, its regularizer and the gradients of both, and ``NetMDA`` per
   domain and stacked at 512 points and per domain at 128, where the node
   features narrow to 32 rows and the attentions to 512 features, with the
   regularizer of the ops' terms;
5. the DG ``_loss(train=True)`` and its gradients, sequential and stacked,
   with the slice's configuration at narrow widths;
6. the slice's configuration at full width through ``train_dg_single_gpu
   --device cpu`` at 128 points: one epoch, then ``--resume`` for a second,
   the regularizer in every step's loss, the occupancy guard in the log.

Both packages run on the JAX package's pyramids from the JAX trainer's FPS
starts (``jax_on_pyramid`` and ``replayed_pyramid``), in float64 on the JAX side
(``_JnpF64``, as ``tests/test_torch_port_kpconv_models.py`` says), so the
tolerances are PR 17's: the port in float64 within 1e-9 relative of the
losses and values and 1e-6 relative L2 of each gradient leaf (a leaf zero
up to rounding against 1e-2 of the largest); in float32 the losses within
1e-5 relative, the generator's values within 1e-4 and its gradients within
1e-3 relative L2 (the JAX package's own f32 gradients lie 1e-4 from its
f64 ones there).
"""

from __future__ import annotations

import glob
import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sug_tpu.engine import dg_trainer as jdt
from sug_tpu.models import bn as jbn
from sug_tpu.models import kpconv as jk
from sug_tpu.models.net_mda import NetMDA as JNetMDA
from sug_tpu_torch import train_dg_single_gpu
from sug_tpu_torch.data.datasets import DATASET_LIST, PointCloudDataset, make_synthetic_pointda
from sug_tpu_torch.engine import dg_trainer as tdt
from sug_tpu_torch.models import kpconv as tk
from sug_tpu_torch.models.net_mda import NetMDA
from sug_tpu_torch.utils.config import parser_config
from sug_tpu_torch.utils.jax_bridge import load_jax_variables
from tests._torch_port_common import (  # noqa: F401
    assert_rel_l2,
    one_torch_thread,
    port_weights_as_jax,
    t,
)
from tests.test_torch_port_kpconv import neighbour_rows_differ
from tests.test_torch_port_kpconv_deform import SLICE_ARCH, randomize_offset_bias
from tests.test_torch_port_kpconv_models import (
    as_port,
    grads_f64,
    jax_on_pyramid,
    rel_l2,
    replayed_pyramid,
    unit_clouds,
)

CFGS = os.path.join(os.path.dirname(__file__), "..", "tools", "cfgs", "cfgs_local")
KPCONV_YAML = os.path.join(CFGS, "DG_unified_loss_onedataset_modelnet_KPConv.yaml")
# the slice's MODEL_CFG over the shipped KPConv config; {narrow} narrows the
# widths for the comparisons with the JAX package
SLICE_YAML = """_BASE_CONFIG_: {base}
MODEL_CFG:
    pyramid: fps
    architecture: [{arch}]{narrow}
"""
NARROW = "\n    first_feats_dim: 16"
FPS_CFG = {"pyramid": "fps"}
# the generator's and NetMDA's tests: six blocks, the last three deformable
# (one strided), modulated, so the heads take the encoder's 64 channels
NET_CFG = {"pyramid": "fps", "first_feats_dim": 16, "MODULATED": True,
           "ARCHITECTURE": ["simple", "resnetb", "resnetb_strided", "resnetb_deformable",
                            "resnetb_deformable_strided", "resnetb_deformable"]}
F64_REL = 1e-9
F64_GRAD_REL_L2 = 1e-6
LOSS_RTOL = 1e-5
F32_VALUE_REL_L2 = 1e-4
F32_GRAD_REL_L2 = 1e-3
METRICS = ("loss_cls", "loss_adv", "loss_geo", "loss_sem", "loss_total")
KEYS = ("logits1", "logits2", "sem1", "sem2", "global_feat", "node_flat", "node_attn",
        "node_attn_t")


@pytest.fixture(autouse=True)
def _jax_bn_state():
    yield
    jbn.reset_bn_groups()


def slice_yaml(path, narrow=False):
    path.write_text(SLICE_YAML.format(base=KPCONV_YAML, arch=", ".join(SLICE_ARCH),
                                      narrow=NARROW if narrow else ""))
    return str(path)


def jax_fps_pyramid(pc, cfg, starts):
    """The JAX package's FPS pyramid of ``pc`` from ``starts`` (numpy)."""
    return jax.tree.map(np.asarray, jax.jit(lambda p, s: jk.build_pyramid(p, cfg, s))(
        pc, jnp.asarray(starts, jnp.int32)))


def sown_regularizer(sown):
    """The JAX package's regularizer of a sown ``regularizers`` tree."""
    return float(jk.p2p_fitting_regularizer(sown))


# 1. the pyramid ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 520])
def test_fps_pyramid_matches_jax(n):
    pc = unit_clouds(n, 3, n)
    starts = np.array([0, n - 1, 77])
    jcfg = dict(jk.KPCONV_DEFAULTS, **FPS_CFG)
    want = jax_fps_pyramid(pc, jcfg, starts)
    pct = t(pc).requires_grad_(True)
    got = tk.build_pyramid(pct, tk.kpconv_config(FPS_CFG), torch.from_numpy(starts))
    assert got["valid"] is None and want["valid"] is None
    sizes = [p.shape[1] for p in got["points"]]
    assert sizes == [n, n // 4, max(n // 16, 4), max(n // 32, 4), max(n // 64, 4)]
    assert not any(p.requires_grad for p in got["points"][1:])
    r0 = jcfg["first_subsampling_dl"] * jcfg["conv_radius"]
    differ = 0
    for lvl, (p, jp) in enumerate(zip(got["points"], want["points"])):
        np.testing.assert_array_equal(p.detach().numpy(), jp, err_msg=f"level {lvl}")
        for which, q_lvl in (("neighbors", lvl), ("pools", lvl + 1)):
            if q_lvl == len(sizes):
                continue
            jq = want["points"][q_lvl]
            differ += neighbour_rows_differ(jp, jq, r0 * 2**lvl, got[which][lvl], want[which][lvl],
                                            np.ones(jq.shape[:2]))
    print(f"N={n}: neighbour rows differing (radius ties): {differ}")
    # the later levels start at index 0: level 2 is the FPS of level 1 from 0
    lvl1 = got["points"][1].detach()
    again = tk.index_points(lvl1, tk.farthest_point_sample(lvl1, sizes[2]))
    assert torch.equal(again, got["points"][2])


# 2. the mask-free forms --------------------------------------------------------------

def test_mask_free_forms():
    rng = np.random.default_rng(21)
    x = (rng.normal(size=(3, 130, 16)) * 3 + 1).astype(np.float32)
    got = tk.instance_norm(t(x), None).numpy()
    want = np.asarray(jk.InstanceNorm().apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    unbiased = (t(x) - t(x).mean(1, keepdim=True)) * torch.rsqrt(t(x).var(1, keepdim=True)
                                                                 + 1e-5)
    assert np.abs(unbiased.numpy() - want).max() > 1e-3  # torch.var's default is not it
    np.testing.assert_allclose(tk._masked_mean(t(x), None).numpy(),
                               np.asarray(jk._masked_mean(jnp.asarray(x), None)), rtol=1e-6)

    for n1 in (130, 32, 256, 3):
        tap = np.broadcast_to(np.arange(n1, dtype=np.float32)[None, :, None], (2, n1, 4)).copy()
        got = tk._sample_tensor_slices(t(tap), None, 64).numpy()
        want = np.asarray(jk._sample_tensor_slices(jnp.asarray(tap), None, 64))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (2, min(n1, 64), 4)
    # at 130 rows (N=520): rows 0, 2, 4, ... against the masked form's i·130 // 64
    tap = np.broadcast_to(np.arange(130, dtype=np.float32)[None, :, None], (2, 130, 4)).copy()
    rows = tk._sample_tensor_slices(t(tap), None, 64)[0, :, 0].numpy()
    masked = tk._sample_tensor_slices(t(tap), torch.ones(2, 130), 64)[0, :, 0].numpy()
    np.testing.assert_array_equal(rows, np.arange(0, 128, 2))
    first = int(np.nonzero(rows != masked)[0][0])
    assert first == 32 and (rows[:32] == masked[:32]).all()


# 3. the occupancy guard --------------------------------------------------------------

def test_occupancy_guard(caplog):
    pc = unit_clouds(30, 8, 512)
    logger = logging.getLogger("kpconv-fps-occupancy")
    with caplog.at_level(logging.INFO, logger="kpconv-fps-occupancy"):
        got = tk.check_neighbor_occupancy(pc, {"PYRAMID": "fps"}, logger=logger)
    want = jk.check_neighbor_occupancy(pc, {"PYRAMID": "fps"})
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(got) == 5 and min(got) >= 1.0
    assert "KPConv pyramid occupancy (mean valid neighbors/level): L0=" in caplog.text


# 4. the generator and NetMDA -----------------------------------------------------------

def test_generator_values_regularizer_and_gradients(monkeypatch):
    pc = unit_clouds(31, 2, 512)
    starts = np.array([5, 300])
    port = tk.KPConvGenerator(NET_CFG)
    tk.init_kpconv_weights_(port, torch.Generator().manual_seed(0))
    randomize_offset_bias(port, 1)
    jgen = jk.KPConvGenerator(cfg=NET_CFG)
    variables = port_weights_as_jax(jgen, port.state_dict(), jnp.zeros((2, 512, 3)), True)
    load_jax_variables(port, variables)
    cot = np.random.default_rng(1).normal(size=(2, port.encoder.out_dim))
    pyr = jax_fps_pyramid(pc, dict(jk.KPCONV_DEFAULTS, **NET_CFG), starts)

    def f(params, pc):
        (g, node, _), state = jgen.apply({"params": params}, pc, True,
                                         mutable=["regularizers"])
        reg = jk.p2p_fitting_regularizer(state["regularizers"])
        return jnp.sum(g * cot) + reg, (g, node, reg)

    (_, want), jgrads = jax_on_pyramid(jax.value_and_grad(f, has_aux=True), [pyr],
                                       variables["params"], pc, f64=True)
    want_grads = grads_f64(jgrads)
    for dtype, value_bound, grad_bound in ((torch.float64, F64_REL, F64_GRAD_REL_L2),
                                           (torch.float32, F32_VALUE_REL_L2, F32_GRAD_REL_L2)):
        port.to(dtype).zero_grad()
        terms = []
        with replayed_pyramid(monkeypatch, as_port(pyr, dtype)):
            g, node, off = port(t(pc).to(dtype), torch.from_numpy(starts), terms)
        assert off is None and node.shape == (2, 64, 16) and len(terms) == 3
        reg = tk.p2p_fitting_regularizer(terms)
        ((g * torch.from_numpy(cot).to(dtype)).sum() + reg).backward()
        grads = {n: p.grad.double().numpy() for n, p in port.named_parameters()}
        gaps = (rel_l2(g.detach(), want[0]), rel_l2(node, want[1]),
                abs(reg.item() - want[2]) / abs(want[2]))
        print(f"{dtype}: global {gaps[0]:.3e}, node {gaps[1]:.3e}, regularizer {gaps[2]:.3e}")
        assert max(gaps) <= value_bound
        assert_rel_l2(grads, want_grads, grad_bound)
    port.float()


@pytest.mark.parametrize("n,domain", [(512, "stacked"), (128, "both")],
                         ids=["512-stacked", "128-both"])
def test_net_mda_per_domain_and_stacked(n, domain, monkeypatch):
    """Train mode from the same weights and BN statistics, in float64 on
    both sides, on the JAX pyramid from the given starts: every output and
    the regularizer of the ops' terms; stacked (2B clouds, source half then
    target half) at 512 points, per domain ("both": both attentions on the
    same clouds) at 128, where the tap level has 32 rows, so the node
    features and the attentions narrow."""
    pcs = unit_clouds(32 + n, 4, n)
    port = NetMDA("KPConv", generator=torch.Generator().manual_seed(1), num_points=n,
                  model_cfg=NET_CFG)
    randomize_offset_bias(port, 2)
    rows = min(64, max(n // 4, 4))
    assert port.attention_s.dense0.in_features == rows * 16
    jmodel = JNetMDA(model_name="KPConv", model_cfg=NET_CFG)
    variables = port_weights_as_jax(jmodel, port.state_dict(), jnp.zeros((2, n, 3)), True,
                                    domain="both")
    pc = pcs if domain == "stacked" else pcs[:2]
    starts = np.arange(len(pc)) * 7
    load_jax_variables(port, variables)
    port.double().train()
    pyr = jax_fps_pyramid(pc, dict(jk.KPCONV_DEFAULTS, **NET_CFG), starts)
    want, state = jax_on_pyramid(
        lambda v, p: jmodel.apply(v, p, True, domain=domain,
                                  mutable=["batch_stats", "regularizers"]),
        [pyr], variables, pc, f64=True)
    with torch.no_grad(), replayed_pyramid(monkeypatch, as_port(pyr, torch.float64)):
        got = port(t(pc).double(), domain, torch.from_numpy(starts))
    assert set(got) == set(want) | {"regularizers"} and got["node_offset"] is None
    assert got["node_flat"].shape == (len(pc), rows * 16) and len(got["regularizers"]) == 3
    gaps = {k: rel_l2(got[k], want[k]) for k in KEYS}
    with jax.enable_x64():
        jreg = sown_regularizer(state["regularizers"])
    gaps["regularizer"] = abs(tk.p2p_fitting_regularizer(got["regularizers"]).item()
                              - jreg) / abs(jreg)
    print(f"N={n} {domain}: {max(gaps.values()):.3e} ({max(gaps, key=gaps.get)})")
    assert max(gaps.values()) <= F64_REL, gaps
    port.float()


# 5. the DG loss ----------------------------------------------------------------------------

B, N = 4, 512


def _source_dataset():
    """An unbalanced source split, so the DLSA class weights differ."""
    labels = np.repeat(np.arange(10), [9, 2, 5, 3, 7, 1, 4, 6, 2, 8])
    return PointCloudDataset("modelnet", unit_clouds(8, len(labels), 64), labels, num_points=64)


@pytest.mark.parametrize("stacked", [False, True], ids=["sequential", "stacked"])
def test_dg_loss_and_gradients(stacked, tmp_path, monkeypatch):
    monkeypatch.setenv("SUG_KPCONV_STACKED", "1" if stacked else "0")
    monkeypatch.delenv("SUG_STACKED_FORWARD", raising=False)
    _, cfg = parser_config(["--cfg", slice_yaml(tmp_path / "slice.yaml", narrow=True)])
    assert cfg["Model"] == "KPConv" and cfg["MODEL_CFG"]["pyramid"] == "fps"
    ds = _source_dataset()
    jtr = jdt.DGTrainer(cfg, model_name="KPConv", augment=False,
                        criterion=jdt.make_criterion(cfg["OPTIMIZATION"], ds))
    tr = tdt.DGTrainer(cfg, model_name="KPConv", augment=False, device="cpu", num_points=N)
    tr.criterion = tdt.make_criterion(cfg["OPTIMIZATION"], ds)
    assert tdt.stacked_forward("KPConv") == stacked
    randomize_offset_bias(tr.model, 3)
    variables = port_weights_as_jax(jdt.NetMDA(model_name="KPConv", model_cfg=cfg["MODEL_CFG"]),
                                    tr.model.state_dict(), jnp.zeros((B, N, 3)), True,
                                    domain="both")
    load_jax_variables(tr.model, variables)
    initial = {n: b.clone() for n, b in tr.model.named_buffers()}

    clouds = unit_clouds(9, 2 * B, N)
    batch = (clouds[:B], np.array([0, 1, 2, 5], np.int32), clouds[B:],
             np.array([0, 4, 2, 7], np.int32))
    key = jax.random.key(0)
    # the FPS starts the JAX trainer draws from its key
    fps_s, fps_t = (np.array(jax.random.randint(k, (B,), 0, N))
                    for k in jax.random.split(key, 4)[:2])
    kp_cfg = tr.model.g.encoder.cfg
    if stacked:
        pyrs = [jax_fps_pyramid(clouds, kp_cfg, np.concatenate([fps_s, fps_t]))]
    else:
        pyrs = [jax_fps_pyramid(batch[0], kp_cfg, fps_s), jax_fps_pyramid(batch[2], kp_cfg, fps_t)]

    def fn(params, batch_stats, *data):
        loss = lambda p: jtr._loss(p, batch_stats, *data, key, jnp.zeros(()),  # noqa: E731
                                   mmd_on=True, train=True)
        return jax.value_and_grad(loss, has_aux=True)(params)

    (_, (_, want)), jgrads = jax_on_pyramid(fn, pyrs, variables["params"],
                                            variables["batch_stats"], *batch, f64=True)
    want_grads = grads_f64(jgrads)
    tbatch = (t(batch[0]), torch.from_numpy(batch[1]).long(), t(batch[2]),
              torch.from_numpy(batch[3]).long())
    starts = (torch.from_numpy(fps_s).long(), torch.from_numpy(fps_t).long())
    for dtype in (torch.float64, torch.float32):
        tr.model.to(dtype).load_state_dict(initial, strict=False)
        data = [a.to(dtype) if a.is_floating_point() else a for a in tbatch]
        with replayed_pyramid(monkeypatch, *[as_port(p, dtype) for p in pyrs]):
            total, got = tr._loss(*data, *starts, mmd_on=True, train=True)
        grads = {n: (np.zeros(tuple(p.shape)) if g is None else g.double().numpy())
                 for (n, p), g in zip(tr.params, tr.grads(total))}
        for k in METRICS:
            print(f"{dtype} {k}: {got[k].item()!r} vs {float(want[k])!r}")
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=F64_REL if dtype == torch.float64 else LOSS_RTOL,
                                       atol=1e-12, err_msg=f"{k} ({dtype})")
        assert got["loss_reg"].item() > 0
        if dtype == torch.float64:
            assert_rel_l2(grads, want_grads, F64_GRAD_REL_L2)
            deform = [n for n in grads if "offset" in n]
            assert deform and all(np.abs(grads[n]).max() > 0 for n in deform)
    tr.model.float()


# 6. the entry point -------------------------------------------------------------------------

def test_slice_config_trains_and_resumes(tmp_path, monkeypatch):
    monkeypatch.delenv("SUG_KPCONV_STACKED", raising=False)
    monkeypatch.delenv("SUG_STACKED_FORWARD", raising=False)
    root = tmp_path / "data" / "PointDA_data"
    for i, name in enumerate(DATASET_LIST):
        (root / name).mkdir(parents=True)
        for j, split in enumerate(("train", "test")):
            pts, labels = make_synthetic_pointda(num_per_class=2, num_points=128, seed=10 * i + j)
            np.save(root / name / f"{split}_pts.npy", pts)
            np.save(root / name / f"{split}_label.npy", labels)
    yaml = slice_yaml(tmp_path / "slice.yaml")

    def argv(epochs, *extra):
        return ["--source", "modelnet", "--cfg", yaml, "--batch_size", "10", "--num_points",
                "128", "--device", "cpu", "--ckpt_save_interval", "1", "--fix_random_seed",
                *extra, "--set", "DATA_ROOT", str(root), "OPTIMIZATION.NUM_EPOCHES", str(epochs)]

    (epoch0,) = train_dg_single_gpu.main(argv(1))["history"]
    assert epoch0["steps"] > 0 and epoch0["loss_geo"] == 0.0  # PURE_CLS_EPOCH
    ckpt = glob.glob(str(root / "output" / "**" / "modelnet_checkpoint_epoch_1.pt"),
                     recursive=True)
    (epoch1,) = train_dg_single_gpu.main(argv(2, "--resume", ckpt[0]))["history"]
    assert epoch1["epoch"] == 1 and epoch1["loss_geo"] > 0
    for h in (epoch0, epoch1):
        assert math.isfinite(h["loss_reg"]) and h["loss_reg"] > 0
        assert all(math.isfinite(h[k]) for k in ("loss_cls", "loss_adv", "loss_geo", "loss_sem"))
    state = torch.load(ckpt[0], map_location="cpu", weights_only=False)["state"]
    assert sum(k.endswith("offset_conv.weights") for k in state) == 5
    logs = glob.glob(str(root / "output" / "**" / "log_train_dg*.txt"), recursive=True)
    text = "".join(open(p).read() for p in logs)
    assert text.count("KPConv pyramid occupancy (mean valid neighbors/level): L0=") == 2
    assert "loss_reg (the deformable KPConv regularizer)" in text
