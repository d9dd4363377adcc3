"""Load checkpoints of the reference PyTorch repo (SiyuanHuang95/SUG) into
the port: the counterpart of ``sug_tpu/utils/torch_convert.py``, mapping the
reference ``Net_MDA`` ``state_dict`` straight onto the port's ``NetMDA``
``state_dict`` for DGCNN, PTran, Pointnet and Pointnet2. The widths and the
math are the same; the transforms are:

- a 1x1 ``Conv2d``/``Conv1d`` weight ``(out, in, 1[, 1])`` becomes the
  ``(out, in)`` weight of a Dense, a ``Linear`` weight stays as it is;
- a BatchNorm's ``weight``, ``bias``, ``running_mean`` and ``running_var``
  keep their names, except in DGCNN's EdgeConv blocks (``bn_scale``,
  ``bn_bias``, ``bn_mean``, ``bn_var``); ``num_batches_tracked`` is dropped;
- the reference flattens the node features channel-major, (C, node), and
  the port node-major, (node, C), as the JAX package does, so every weight
  that touches the 4096-d flattened node vector (both CALayers) is permuted
  by ``NODE_PERM``.

The reference's dead parameters are dropped: ``adapt_layer_off.trans``
(defined, never called), DGCNN's ``input_transform_net`` (its use is
commented out) and Pointnet2's ``channel_redu`` (never called). KPConv has
no converter, by design, as in the JAX package: its fixed-capacity pyramid
is a redesign of the reference's, so whole-model weights do not carry over.

``synthetic_reference_state_dict`` makes a seeded state dict under the
reference's key names and shapes, for tests and smoke runs: no reference
checkpoint is needed to exercise the converter.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

NUM_NODE = 64
NODE_CH = 64
# port_flat[j] (node-major, j = n*C + c) == ref_flat[NODE_PERM[j]] (channel-major, i = c*S + n)
NODE_PERM = torch.from_numpy(np.arange(NUM_NODE * NODE_CH).reshape(NUM_NODE, NODE_CH).T.ravel())
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")

SD = Dict[str, torch.Tensor]


def _t(value) -> torch.Tensor:
    """A state-dict value (tensor or array) as a detached f32 CPU tensor."""
    return torch.as_tensor(np.asarray(value.detach().cpu() if hasattr(value, "detach") else value),
                           dtype=torch.float32)


def _dense(sd: Mapping, src: str, dst: str) -> SD:
    """A conv or linear layer: ``{dst}.weight`` (out, in) and, where the
    reference has one, ``{dst}.bias``."""
    w = _t(sd[f"{src}.weight"])
    out = {f"{dst}.weight": w.reshape(w.shape[0], w.shape[1]).contiguous()}
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _t(sd[f"{src}.bias"])
    return out


def _bn(sd: Mapping, src: str, dst: str) -> SD:
    return {f"{dst}.{leaf}": _t(sd[f"{src}.{leaf}"]) for leaf in BN_LEAVES}


def _conv_bn(sd: Mapping, src: str, dst: str) -> SD:
    """The reference's ``conv_2d`` (``.conv.0`` conv, ``.conv.1`` BN) -> ``ConvBN``."""
    return {**_dense(sd, f"{src}.conv.0", f"{dst}.dense0"), **_bn(sd, f"{src}.conv.1", f"{dst}.bn")}


def _fc_layer(sd: Mapping, src: str, dst: str) -> SD:
    """The reference's ``fc_layer`` (``.fc.0`` Linear, ``.fc.1`` LayerNorm) -> ``FCLayer``."""
    ln = {f"{dst}.ln.{leaf}": _t(sd[f"{src}.fc.1.{leaf}"]) for leaf in ("weight", "bias")}
    return {**_dense(sd, f"{src}.fc.0", f"{dst}.dense0"), **ln}


def _transform_net(sd: Mapping, src: str, dst: str) -> SD:
    out = {}
    for i in range(3):
        out.update(_conv_bn(sd, f"{src}.conv2d{i + 1}", f"{dst}.convbn{i}"))
    out.update(_fc_layer(sd, f"{src}.fc1", f"{dst}.fc0"))
    out.update(_fc_layer(sd, f"{src}.fc2", f"{dst}.fc1"))
    out.update(_dense(sd, f"{src}.fc3", f"{dst}.dense0"))
    return out


def _adapt_layer(sd: Mapping, src: str, dst: str) -> SD:
    """``adapt_layer_off`` -> the SA-node (``.trans`` is dead)."""
    return {**_dense(sd, f"{src}.pred_offset.0", f"{dst}.pred_offset"),
            **_conv_bn(sd, f"{src}.residual", f"{dst}.residual")}


def _ca_layer(sd: Mapping, src: str) -> SD:
    """``CALayer`` with ``NODE_PERM`` folded into every weight that touches
    the 4096-d node vector: the first Linear's inputs, the second's outputs
    and the BN's features."""
    p = NODE_PERM
    d0, d1 = _dense(sd, f"{src}.conv_du.0", "d0"), _dense(sd, f"{src}.conv_du.2", "d1")
    out = {f"{src}.dense0.weight": d0["d0.weight"][:, p].contiguous(),
           f"{src}.dense0.bias": d0["d0.bias"],
           f"{src}.dense1.weight": d1["d1.weight"][p].contiguous(),
           f"{src}.dense1.bias": d1["d1.bias"][p].contiguous()}
    out.update({k: v[p].contiguous() for k, v in _bn(sd, f"{src}.bn", f"{src}.bn").items()})
    return out


def _head(sd: Mapping, src: str, ptran: bool) -> SD:
    """``Pointnet_c`` -> ``ClassifierHead`` (PTran's has no ``mlp1``)."""
    out = {**_fc_layer(sd, f"{src}.mlp2", f"{src}.mlp2"), **_dense(sd, f"{src}.mlp3", f"{src}.mlp3")}
    if not ptran:
        out.update(_fc_layer(sd, f"{src}.mlp1", f"{src}.mlp1"))
    return out


def _pointnet(sd: Mapping) -> SD:
    out = {}
    for name in ("trans_net1", "trans_net2"):
        out.update(_transform_net(sd, f"g.{name}", f"g.{name}"))
    for name in ("conv1", "conv2", "conv4", "conv5"):
        out.update(_conv_bn(sd, f"g.{name}", f"g.{name}"))
    out.update(_adapt_layer(sd, "g.conv3", "g.sa_node"))
    out.update(_bn(sd, "g.bn1", "g.bn1"))
    return out


def _dgcnn(sd: Mapping) -> SD:
    """``input_transform_net`` is dead."""
    out = {}
    for i in range(1, 5):
        src, dst = f"g.conv{i}", f"g.block{i}"
        out.update(_dense(sd, f"{src}.conv.0", f"{dst}.conv_dense"))
        bn = _bn(sd, f"{src}.conv.1", "bn")
        out.update({f"{dst}.bn_scale": bn["bn.weight"], f"{dst}.bn_bias": bn["bn.bias"],
                    f"{dst}.bn_mean": bn["bn.running_mean"], f"{dst}.bn_var": bn["bn.running_var"]})
    out.update(_adapt_layer(sd, "g.node_fea_adapt", "g.sa_node"))
    out.update(_dense(sd, "g.conv1d", "g.reproject"))
    out.update(_dense(sd, "g.conv5", "g.conv5"))
    out.update(_bn(sd, "g.bn5", "g.bn5"))
    return out


def _pointnet2(sd: Mapping) -> SD:
    """``channel_redu`` is dead."""
    out = {}
    for sa in ("sa1", "sa2", "sa3"):
        for i in range(3):
            out.update(_dense(sd, f"g.{sa}.mlp_convs.{i}", f"g.{sa}.mlp{i}.dense0"))
            out.update(_bn(sd, f"g.{sa}.mlp_bns.{i}", f"g.{sa}.mlp{i}.bn"))
    return out


def _vecattn_block(sd: Mapping, src: str, dst: str) -> SD:
    out = {}
    for s, d in (("fc1", "fc1"), ("fc2", "fc2"), ("fc_delta.0", "fc_delta1"),
                 ("fc_delta.2", "fc_delta2"), ("fc_gamma.0", "fc_gamma1"),
                 ("fc_gamma.2", "fc_gamma2"), ("w_qs", "w_qs"), ("w_ks", "w_ks"), ("w_vs", "w_vs")):
        out.update(_dense(sd, f"{src}.{s}", f"{dst}.{d}"))
    return out


def _ptran(sd: Mapping) -> SD:
    """``PTran_g``: ``fc1`` -> ``fc1a``/``fc1b``, the TransitionDowns' two
    conv + BN stages -> two ConvBNs, and the stride-2 point-mixing ``conv1d``
    -> ``point_mix``, a Dense over the point axis (its flatten order is
    absorbed by the CALayers' ``NODE_PERM``, as for the other backbones)."""
    bk = "g.backbone"
    out = {**_dense(sd, "g.fc1.0", f"{bk}.fc1a"), **_dense(sd, "g.fc1.2", f"{bk}.fc1b"),
           **_vecattn_block(sd, "g.transformer1", f"{bk}.transformer1")}
    for i in range(4):
        for j in range(2):
            src = f"g.transition_downs.{i}.sa"
            out.update(_dense(sd, f"{src}.mlp_convs.{j}", f"{bk}.td{i}.mlp{j}.dense0"))
            out.update(_bn(sd, f"{src}.mlp_bns.{j}", f"{bk}.td{i}.mlp{j}.bn"))
        out.update(_vecattn_block(sd, f"g.transformers.{i}", f"{bk}.transformer{i + 2}"))
    out.update(_dense(sd, "g.conv1d", "g.point_mix"))
    return out


_GENERATORS = {"Pointnet": _pointnet, "DGCNN": _dgcnn, "Pointnet2": _pointnet2, "PTran": _ptran}


def convert_net_mda(sd: Mapping, model_name: str = "Pointnet") -> SD:
    """A reference ``Net_MDA`` state dict (tensors or arrays by name) ->
    the port's ``NetMDA(model_name)`` state dict, which loads strictly.
    KPConv and an unknown name raise ``NotImplementedError``."""
    if model_name not in _GENERATORS:
        if model_name == "KPConv":
            raise NotImplementedError(
                "KPConv whole-model conversion is unsupported by design: the port's pyramid, as "
                "the JAX package's, is a fixed-capacity redesign of the reference's dynamic "
                "stacked-rows preprocessing, so its weights do not carry over")
        raise NotImplementedError(f"no converter for model_name={model_name!r} "
                                  f"(have {sorted(_GENERATORS)})")
    out = _GENERATORS[model_name](sd)
    for att in ("attention_s", "attention_t"):
        out.update(_ca_layer(sd, att))
    for head in ("c1", "c2"):
        out.update(_head(sd, head, ptran=model_name == "PTran"))
    return out


def load_reference_checkpoint(path: str, model_name: str = "Pointnet",
                              key: Optional[str] = None) -> SD:
    """A reference ``.pth`` file, converted (``convert_net_mda``). The file
    holds a raw state dict (the reference's ``torch.save(model.state_dict())``)
    or one wrapped under ``key``, else under ``model_state``, ``state_dict``
    or ``model``; a ``module.`` prefix on every key (DataParallel) is
    dropped. Read with ``weights_only=True``: tensors and plain containers
    only."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None:
        blob = blob[key]
    elif isinstance(blob, dict) and not any(torch.is_tensor(v) for v in blob.values()):
        for guess in ("model_state", "state_dict", "model"):
            if guess in blob:
                blob = blob[guess]
                break
    if all(k.startswith("module.") for k in blob):
        blob = {k[len("module."):]: v for k, v in blob.items()}
    return convert_net_mda(blob, model_name)


def synthetic_reference_state_dict(model_name: str, seed: int = 0, num_class: int = 10,
                                   num_points: int = 1024) -> Dict[str, np.ndarray]:
    """A seeded ``Net_MDA`` state dict under the reference's key names and
    shapes (1x1 convs as ``Conv2d``/``Conv1d`` weights, ``num_batches_tracked``
    and the dead parameters included), as numpy: weights normal of variance
    1/fan_in, biases and BN statistics random, a third of the BN scales
    negative. ``num_points`` sizes PTran's point-mixing conv."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def dense(name, fan_in, fan_out, bias=True, conv=0):
        shape = (fan_out, fan_in) + (1,) * conv
        sd[f"{name}.weight"] = rng.normal(0.0, fan_in ** -0.5, shape).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = rng.normal(0.0, 0.1, fan_out).astype(np.float32)

    def bn(name, n):
        sign = np.where(rng.uniform(size=n) < 0.35, -1.0, 1.0)
        sd[f"{name}.weight"] = (sign * rng.uniform(0.5, 1.5, n)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0.0, 0.1, n).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0.0, 0.2, n).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(int(rng.integers(1, 1000)), np.int64)

    def conv_2d(name, fan_in, fan_out, bias=True):
        dense(f"{name}.conv.0", fan_in, fan_out, bias, conv=2)
        bn(f"{name}.conv.1", fan_out)

    def fc_layer(name, fan_in, fan_out, bias):
        dense(f"{name}.fc.0", fan_in, fan_out, bias)
        sd[f"{name}.fc.1.weight"] = rng.uniform(0.5, 1.5, fan_out).astype(np.float32)
        sd[f"{name}.fc.1.bias"] = rng.normal(0.0, 0.1, fan_out).astype(np.float32)

    def transform_net(name, fan_in, k):
        for i, (a, b) in enumerate(((fan_in, 64), (64, 128), (128, 1024))):
            conv_2d(f"{name}.conv2d{i + 1}", a, b)
        fc_layer(f"{name}.fc1", 1024, 512, bias=False)
        fc_layer(f"{name}.fc2", 512, 256, bias=False)
        dense(f"{name}.fc3", 256, k * k)

    def adapt_layer(name, c):
        dense(f"{name}.pred_offset.0", c, 3, bias=False, conv=1)
        conv_2d(f"{name}.residual", c, c)
        conv_2d(f"{name}.trans", c, c)  # dead

    def transformer(name, d_points, d_model=512):
        dense(f"{name}.fc1", d_points, d_model)
        dense(f"{name}.fc2", d_model, d_points)
        dense(f"{name}.fc_delta.0", 3, d_model)
        dense(f"{name}.fc_delta.2", d_model, d_model)
        dense(f"{name}.fc_gamma.0", d_model, d_model)
        dense(f"{name}.fc_gamma.2", d_model, d_model)
        for w in ("w_qs", "w_ks", "w_vs"):
            dense(f"{name}.{w}", d_model, d_model, bias=False)

    if model_name == "Pointnet":
        transform_net("g.trans_net1", 3, 3)
        conv_2d("g.conv1", 3, 64)
        conv_2d("g.conv2", 64, 64)
        transform_net("g.trans_net2", 64, 64)
        adapt_layer("g.conv3", 64)
        conv_2d("g.conv4", 128, 128)
        conv_2d("g.conv5", 128, 1024)
        bn("g.bn1", 1024)
    elif model_name == "DGCNN":
        transform_net("g.input_transform_net", 6, 3)  # dead
        for i, (a, b) in enumerate(((6, 64), (128, 64), (128, 128), (256, 256))):
            conv_2d(f"g.conv{i + 1}", a, b, bias=False)
        adapt_layer("g.node_fea_adapt", 64)
        dense("g.conv1d", 128, 64, conv=1)
        dense("g.conv5", 512, 512, bias=False, conv=1)
        bn("g.bn5", 512)
    elif model_name == "Pointnet2":
        for sa, widths in (("sa1", (3, 64, 64, 128)), ("sa2", (128 + 3, 128, 128, 256)),
                           ("sa3", (256 + 3, 256, 512, 1024))):
            for i in range(3):
                dense(f"g.{sa}.mlp_convs.{i}", widths[i], widths[i + 1], conv=2)
                bn(f"g.{sa}.mlp_bns.{i}", widths[i + 1])
        dense("g.channel_redu", 128, 64, conv=1)  # dead
    elif model_name == "PTran":
        dense("g.fc1.0", 3, 32)
        dense("g.fc1.2", 32, 32)
        transformer("g.transformer1", 32)
        for i in range(4):
            c = 32 * 2 ** (i + 1)
            for j, fan_in in enumerate((c // 2 + 3, c)):
                dense(f"g.transition_downs.{i}.sa.mlp_convs.{j}", fan_in, c, conv=2)
                bn(f"g.transition_downs.{i}.sa.mlp_bns.{j}", c)
            transformer(f"g.transformers.{i}", c)
        dense("g.conv1d", num_points // 16, 64, conv=1)
    else:
        raise NotImplementedError(f"no synthetic reference state dict for {model_name!r}")
    for att in ("attention_s", "attention_t"):
        dense(f"{att}.conv_du.0", NUM_NODE * NODE_CH, NUM_NODE * NODE_CH // 8)
        dense(f"{att}.conv_du.2", NUM_NODE * NODE_CH // 8, NUM_NODE * NODE_CH)
        bn(f"{att}.bn", NUM_NODE * NODE_CH)
    for head in ("c1", "c2"):
        if model_name != "PTran":
            fc_layer(f"{head}.mlp1", 1024, 512, bias=model_name == "DGCNN")
        fc_layer(f"{head}.mlp2", 512, 256, bias=True)
        dense(f"{head}.mlp3", 256, num_class)
    return sd
