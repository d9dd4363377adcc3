"""The float64 witness of the grouped DGCNN's near-tied neighbours.

``chip_smoke.py`` compares the DGCNN's DG loss with BN groups 2 on the card
and on the CPU on the card's EdgeConv neighbours (``card_neighbours``),
after holding every row where the CPU's own kNN chose another set to a near
tie (``near_tie_gaps``, ``NEAR_TIE_REL``). This file shows, on the CPU
alone, why: the same ``_loss`` (the shipped config's DGCNN with
``BN_SEMANTICS per_replica``, ``BN_GROUPS 2``, at B=8, N=1024, the batch
``chip_smoke.py`` compares, MMD and dropout off) in float32 and, from the
same float32 weights, in float64. Float64 run on float32's neighbours
(as the CPU runs on the card's) would choose other neighbours on some
rows, and each such row is a near tie by ``chip_smoke.py``'s own rule;
it keeps every gradient leaf within the 1e-2 relative L2 that the card is
held to. Float64 left to choose its own neighbours moves some leaf past
that limit: one near tie decided otherwise changes the features that every
later block's kNN reads, so its later choices differ by more than
rounding. The thread count is fixed, so the float32 sums are the same in
every run.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from sug_tpu_torch.data.datasets import PointCloudDataset, make_synthetic_pointda
from sug_tpu_torch.engine.dg_trainer import DGTrainer
from sug_tpu_torch.ops import edgeconv
from sug_tpu_torch.utils.config import parser_config
from tests._torch_port_common import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

B, N = chip_smoke.CARD_B, chip_smoke.N_POINTS


def _loss_grads(dtype, starts, replay=None):
    """Every leaf's gradient of the grouped DGCNN's loss in ``dtype``, and
    each EdgeConv kNN's (q, kv, own indices); with ``replay``, the kNN
    returns those indices of another run instead of its own."""
    _, cfg = parser_config(["--cfg", chip_smoke.YAML, "--set", "Model", "DGCNN",
                            *chip_smoke.BN_GROUPS_SET])
    pts, labels = make_synthetic_pointda(num_per_class=2, num_points=N, seed=7)
    ds = PointCloudDataset("modelnet", pts, labels, num_points=N, model="DGCNN")
    knn, calls = edgeconv.cross_knn_indices, []
    replayed = iter(replay or [])

    def recording(q, kv, k):
        own = knn(q, kv, k)
        calls.append((q.detach(), kv.detach(), own))
        return own if replay is None else next(replayed)[2]

    edgeconv.cross_knn_indices = recording
    try:
        tr = DGTrainer(cfg, model_name="DGCNN", augment=False, device="cpu", seed=0)
        tr.model.to(dtype)  # the float32 initial weights, exactly, in either type
        tr.model.c1.dropout_rate = tr.model.c2.dropout_rate = 0.0
        batch = [torch.from_numpy(ds.pts[:B]).to(dtype),
                 torch.from_numpy(ds.labels[:B].astype(np.int64)),
                 torch.from_numpy(ds.pts[-B:]).to(dtype),
                 torch.from_numpy(ds.labels[-B:].astype(np.int64))]
        total, _ = tr._loss(*batch, *starts, mmd_on=False, train=True)
        grads = {n: (torch.zeros_like(p) if g is None else g).double()
                 for (n, p), g in zip(tr.params, tr.grads(total))}
    finally:
        edgeconv.cross_knn_indices = knn
    return grads, calls


def _worst(grads, ref):
    """The leaf furthest from ``ref`` in relative L2, as ``chip_smoke.py``
    measures it, and that distance."""
    floor = 1e-2 * max(g.norm().item() for g in ref.values())
    rel = {n: (grads[n] - g).norm().item() / max(g.norm().item(), floor) for n, g in ref.items()}
    name = max(rel, key=rel.get)
    return name, rel[name]


def test_grouped_dgcnn_neighbours_are_decided_by_rounding():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        rng = np.random.default_rng(0)
        starts = [torch.from_numpy(rng.integers(0, N, B)) for _ in range(2)]
        g32, calls32 = _loss_grads(torch.float32, starts)
        g64, _ = _loss_grads(torch.float64, starts)
        g64_on32, calls64 = _loss_grads(torch.float64, starts, replay=calls32)
    finally:
        torch.set_num_threads(threads)

    assert len(calls32) == len(calls64) == 10  # 5 EdgeConv blocks a domain
    differing, widest = 0, 0.0
    for (_, _, own32), (q64, kv64, own64) in zip(calls32, calls64):
        gaps, repeats = chip_smoke.near_tie_gaps(q64, kv64, own32, own64)
        assert not repeats.any()
        differing += len(gaps)
        widest = max([widest, *gaps.tolist()])
    assert differing > 0, "float32 and float64 chose the same neighbours everywhere"
    assert widest <= chip_smoke.NEAR_TIE_REL, widest

    moved, by = _worst(g32, g64)
    assert by > chip_smoke.MAX_GRAD_REL_L2, (moved, by)
    held, within = _worst(g32, g64_on32)
    assert within <= chip_smoke.MAX_GRAD_REL_L2, (held, within)


def test_near_tie_gaps_tell_a_tie_from_a_wrong_neighbour():
    """``near_tie_gaps`` on a line of keys: a query midway between keys 1
    and 2 ties them exactly; choosing key 3 instead is no tie, and a
    repeated key is flagged."""
    kv = torch.tensor([[[0.0], [1.0], [2.0], [3.0]]])
    q = torch.tensor([[[1.5], [1.5], [1.5], [1.5]]])
    own = torch.tensor([[[1, 2], [1, 2], [1, 2], [1, 2]]])
    other = torch.tensor([[[1, 2], [2, 1], [3, 2], [2, 2]]])
    gaps, repeats = chip_smoke.near_tie_gaps(q, kv, other, own)
    assert len(gaps) == 2  # rows 2 and 3; row 1 is the same set in another order
    assert gaps[0] == (2.25 - 0.25) / (2.25 + 9.0)  # k-th distances 2.25 and 0.25, scale 11.25
    assert gaps[1] == 0.0 and repeats.tolist() == [False, True]
    # keys 0 and 3 tie at 2.25 from the query
    gaps, _ = chip_smoke.near_tie_gaps(q, kv, torch.tensor([[[0, 2]] * 4]),
                                       torch.tensor([[[3, 2]] * 4]))
    assert gaps.tolist() == [0.0, 0.0, 0.0, 0.0]
