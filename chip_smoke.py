#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sug_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``. It imports nothing of JAX or of ``sug_tpu``. Every phase that fails
ends the run with a non-zero exit; the phases, in order:

1. card: ``nvidia-smi`` name and power limit, and the torch device name;
2. build: every CUDA source of the main path, compiled from the checkout,
   with its seconds and the ``-Xptxas -v`` register and shared-memory lines;
3. kernels against their plain PyTorch versions on the card, at the shapes
   the DGCNN twin-head forward gives them at B=64, at ragged sizes (N=1000,
   S=61), and on exact-tie inputs;
4. the slice: ``sug_tpu_torch.infer`` (``--dg --batch_size 64``) on a
   synthetic ``--pts`` file and a synthetic 10-class dataset tree, with
   seeded weights, counting kernel launches; then the logits of 16 clouds
   against the same weights on the CPU plain path;
5. times, with CUDA events after warm-up: each kernel shape beside its bound
   and its plain version, the forward per batch of 64, and peak memory;
   then the forward's device time by kernel from ``torch.profiler``.

The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

B = 64  # the serving batch of infer.py
N_POINTS = 1024
# the forward's five edgeconv_reduce calls: (name, S or None for self-kNN, C, F, k)
SHAPES = [
    ("block1", None, 3, 64, 20),
    ("block2", None, 64, 64, 20),
    ("block3", None, 64, 128, 20),
    ("block4", None, 128, 256, 20),
    ("sa_node", 64, 3, 64, 64),
]
# ragged sizes (infer takes any --num_points): N not a multiple of the
# kernel's 64-key chunk and S not a multiple of its 8 queries per block, so
# the partial last chunk and the idle warps of the last block both run
RAGGED_N = 1000
RAGGED = [
    ("ragged self N=1000", None, 64, 64, 20),
    ("ragged cross S=61 N=1000", 61, 3, 64, 64),
]
# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# kernel against plain version: share of rows whose neighbour sets must agree
# (near-tied distances may order differently: the two sum C products in
# different orders), and the tolerance on agreeing rows: 1e-5 relative to
# max(|plain|, 1), since s1/s2 sum the same k terms in a different order
MIN_SET_AGREEMENT = 0.999
REL_TOL = 1e-5
# the slice on the card against the CPU plain path, over 16 clouds
MAX_LOGIT_DIFF = 1e-2
MAX_ARGMAX_DISAGREE = 1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def timed_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def shape_inputs(shape, gen, device, n=N_POINTS):
    """Seeded inputs of one edgeconv_reduce call of the main path."""
    _, S, C, F, k = shape
    if C == 3:  # coordinates: clouds in the unit ball
        kv = torch.randn((B, n, 3), generator=gen, device=device)
        kv = kv / kv.norm(dim=-1).amax(dim=1)[:, None, None]
    else:  # features
        kv = torch.randn((B, n, C), generator=gen, device=device)
    u = torch.randn((B, n, F), generator=gen, device=device)
    if S is None:
        return kv, kv, u, torch.randn((B, n, F), generator=gen, device=device), k
    # SA-node: offset nodes near the cloud, v = 0
    q = (kv[:, :S] + 0.05 * torch.randn((B, S, C), generator=gen, device=device)).contiguous()
    return q, kv, u, torch.zeros((B, S, F), device=device), k


def bound(q, kv, u, v, k):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth (each
    input read once, each output written once) and the f32 distance
    operations 2*B*S*N*C over the f32 peak. The k selection rounds are
    comparisons and are not counted."""
    Bq, S, C = q.shape
    N, F = kv.shape[1], u.shape[-1]
    inputs = [kv, u, v] + ([] if q is kv else [q])
    nbytes = sum(t.numel() * 4 for t in inputs) + 4 * Bq * S * F * 4 + Bq * S * k * 4
    flops = 2.0 * Bq * S * N * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def compare(name, got, want, require_exact_idx=False):
    """Kernel outputs against the plain version's; returns (max_abs_err on
    agreeing rows, share of rows whose neighbour sets agree)."""
    g_idx, w_idx = got[4].long(), want[4].long()
    same_set = (torch.sort(g_idx, -1).values == torch.sort(w_idx, -1).values).all(-1)
    share = same_set.float().mean().item()
    ordered = (g_idx == w_idx).all(-1).float().mean().item()
    max_err = 0.0
    parts = []
    for label, g, w in zip(("amax", "amin", "s1", "s2"), got[:4], want[:4]):
        if not torch.isfinite(g).all():
            fail(f"{name}: {label} has non-finite values")
        d = (g - w).abs()[same_set]
        rel = (d / torch.clamp(w.abs()[same_set], min=1.0)).max().item() if d.numel() else 0.0
        err = d.max().item() if d.numel() else 0.0
        max_err = max(max_err, err)
        parts.append(f"{label} {err:.3e}")
        if rel > REL_TOL:
            fail(f"{name}: {label} differs by {rel:.3e} relative on agreeing rows (> {REL_TOL})")
    print(f"  {name}: sets agree on {share:.6f} of rows, order on {ordered:.6f}; "
          f"max |diff| on agreeing rows: {', '.join(parts)}", flush=True)
    if require_exact_idx and not torch.equal(g_idx, w_idx):
        fail(f"{name}: neighbour indices differ on an exact-tie input")
    if share < MIN_SET_AGREEMENT:
        fail(f"{name}: neighbour sets agree on {share:.6f} of rows (< {MIN_SET_AGREEMENT})")
    return max_err, share


def randomize_bn(model, gen):
    """Random BN running stats, scales of random sign (about a third
    negative, so the EdgeConv epilogue takes its amin branch) and biases."""
    from sug_tpu_torch.models.bn import BatchNorm
    from sug_tpu_torch.models.dgcnn import EdgeConvBlock

    def fill(mean, var, scale, bias):
        n = mean.numel()
        mean.copy_(0.2 * torch.randn(n, generator=gen))
        var.copy_(0.5 + 1.5 * torch.rand(n, generator=gen))
        sign = torch.where(torch.rand(n, generator=gen) < 0.35, -1.0, 1.0)
        scale.copy_(sign * (0.5 + torch.rand(n, generator=gen)))
        bias.copy_(0.1 * torch.randn(n, generator=gen))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                fill(m.running_mean, m.running_var, m.weight, m.bias)
            elif isinstance(m, EdgeConvBlock):
                fill(m.bn_mean, m.bn_var, m.bn_scale, m.bn_bias)


def synthetic_clouds(rng, m):
    """m raw clouds of N_POINTS points and their labels in 10 classes:
    boxes and ellipsoid shells whose aspect ratios depend on the class."""
    labels = np.arange(m) % 10
    pts = rng.normal(size=(m, N_POINTS, 3))
    shell = labels % 2 == 0
    pts[shell] /= np.linalg.norm(pts[shell], axis=-1, keepdims=True)
    pts[~shell] = rng.uniform(-1, 1, size=pts[~shell].shape)
    aspect = 0.3 + 0.15 * labels[:, None] * np.array([1.0, 0.5, 0.25])[None, :]
    pts = pts * aspect[:, None, :] + rng.normal(0, 0.01, size=pts.shape)
    return (3.0 * pts + 1.0).astype(np.float32), labels.astype(np.int64)


def profile_forward(model, batch, fwd_ms: float, iters: int = 3) -> None:
    """Device time per forward by kernel (torch.profiler), and the share of
    the CUDA-event forward time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sug_tpu_torch.models.net_mda import ensemble_logits

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            ensemble_logits(model, batch)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.self_device_time_total / 1e3 / iters, e.count / iters, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    if busy == 0.0:
        print("profile: the profiler recorded no device time (not measured)", flush=True)
        return
    print(f"profile: device busy {busy:.3f} ms per forward, {busy / fwd_ms:.1%} of the "
          f"{fwd_ms:.3f} ms forward; {sum(r[1] for r in rows):.0f} kernels per forward; "
          "top kernels (ms per forward, launches per forward):", flush=True)
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.4f} ms  x{n:<4g} {key[:110]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    try:
        import sug_tpu_torch
    except ImportError as e:
        fail(f"the sug_tpu_torch package is not beside this script: {e}")
    if os.path.dirname(os.path.dirname(os.path.abspath(sug_tpu_torch.__file__))) != HERE:
        fail(f"imported sug_tpu_torch from {sug_tpu_torch.__file__}, not from {HERE}")
    from sug_tpu_torch import infer
    from sug_tpu_torch.engine.checkpoint import save_checkpoint
    from sug_tpu_torch.data.datasets import PointCloudDataset
    from sug_tpu_torch.models.net_mda import NetMDA, ensemble_logits
    from sug_tpu_torch.ops import cuda_build, edgeconv
    from sug_tpu_torch.ops.geometry import farthest_point_sample

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)

    # 2. the build
    built = cuda_build.build("edgeconv_fwd")
    print(f"build edgeconv_fwd: {built.seconds:.2f} s -> {built.path}", flush=True)
    for line in built.log.splitlines():
        if any(w in line for w in ("registers", "bytes smem", "spill", "Function properties")):
            print(f"  ptxas: {line.strip()}", flush=True)

    # 3. kernels against plain versions
    print("kernel vs plain (tolerance: sets agree on >= "
          f"{MIN_SET_AGREEMENT}, agreeing rows to {REL_TOL} rel of max(|plain|,1)):", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    max_abs_err = 0.0
    for shape, n in [(s, N_POINTS) for s in SHAPES] + [(s, RAGGED_N) for s in RAGGED]:
        args = shape_inputs(shape, gen, dev, n)
        got = edgeconv.edgeconv_reduce(*args)
        want = edgeconv.edgeconv_reduce_plain(*args)
        torch.cuda.synchronize()
        err, _ = compare(shape[0], got, want)
        max_abs_err = max(max_abs_err, err)
    # exact ties: integer lattice points, duplicates included, so every
    # distance is exact in f32 and both sides must pick the same indices in
    # the same order (the lowest index first among equal distances)
    lat = torch.randint(-6, 7, (B, N_POINTS, 3), generator=gen, device=dev).float()
    lat[:, 64] = lat[:, 0]
    lat[:, 65] = lat[:, 0]
    lat_r = lat[:, :RAGGED_N].contiguous()
    for name, q, kv, k in (
        ("tie self k=20", lat, lat, 20),
        ("tie cross k=64", lat[:, 128:192].contiguous(), lat, 64),
        ("tie ragged self N=1000 k=20", lat_r, lat_r, 20),
        ("tie ragged cross S=61 N=1000 k=64", lat_r[:, 128:189].contiguous(), lat_r, 64),
    ):
        u = torch.randn((B, kv.shape[1], 64), generator=gen, device=dev)
        v = torch.randn((B, q.shape[1], 64), generator=gen, device=dev)
        got = edgeconv.edgeconv_reduce(q, kv, u, v, k)
        want = edgeconv.edgeconv_reduce_plain(q, kv, u, v, k)
        err, _ = compare(name, got, want, require_exact_idx=True)
        max_abs_err = max(max_abs_err, err)
    # FPS: torch.argmax must return the first maximal index on the card too
    sym = torch.zeros((1, 8, 3))
    sym[0, :, 0] = torch.tensor([0.0, 1, -1, 1, -1, 2, -2, 2])
    if not torch.equal(farthest_point_sample(sym, 5),
                       farthest_point_sample(sym.to(dev), 5).cpu()):
        fail("farthest_point_sample breaks argmax ties differently on the card")
    print("  fps argmax ties: the card matches the CPU", flush=True)

    # 4. the slice through the user's entry point
    torch.manual_seed(0)
    model = NetMDA("DGCNN")
    randomize_bn(model, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # random heads send every cloud to one class: shift each head's output
        # bias by minus its mean logits over calibration clouds
        calib = PointCloudDataset("modelnet", synthetic_clouds(rng, B)[0], np.zeros(B),
                                  num_points=N_POINTS)
        model = model.eval().to(dev)
        with torch.no_grad():
            out = model(torch.from_numpy(calib.pts).to(dev))
            model.c1.mlp3.bias -= out["logits1"].mean(0)
            model.c2.mlp3.bias -= out["logits2"].mean(0)
        ckpt = save_checkpoint(os.path.join(tmp, "dgcnn.pt"), model, epoch=0)

        raw, _ = synthetic_clouds(rng, 256)
        pts_file = os.path.join(tmp, "clouds.npy")
        np.save(pts_file, raw)
        root = os.path.join(tmp, "PointDA")
        os.makedirs(os.path.join(root, "scannet"))
        ds_pts, ds_labels = synthetic_clouds(rng, 100)
        np.save(os.path.join(root, "scannet", "test_pts.npy"), ds_pts)
        np.save(os.path.join(root, "scannet", "test_label.npy"), ds_labels)

        common = ["--ckpt", ckpt, "--model", "DGCNN", "--dg", "--batch_size", str(B),
                  "--num_points", str(N_POINTS), "--device", "cuda"]
        launches = 0
        for label, extra, m in (
            ("pts", ["--pts", pts_file], len(raw)),
            ("dataset", ["--dataset", "scannet", "--split", "test", "--data_root", root], 100),
        ):
            edgeconv.edgeconv_reduce.launches = 0
            result = infer.main(common + extra)
            torch.cuda.synchronize()
            n = edgeconv.edgeconv_reduce.launches
            want_n = len(SHAPES) * math.ceil(m / B)
            print(f"infer --{label}: edgeconv kernel launches {n} "
                  f"({n / math.ceil(m / B):.0f} per batch of {B})", flush=True)
            if n != want_n:
                fail(f"infer --{label}: {n} kernel launches, expected {want_n}")
            launches += n
            if label == "pts":
                preds = result["preds"]
                if preds.shape != (len(raw),) or preds.min() < 0 or preds.max() > 9:
                    fail(f"infer --pts: bad predictions {preds.shape} {preds[:8]}")
            elif not 0.0 <= result["overall_acc"] <= 1.0 or not math.isfinite(result["avg_loss"]):
                fail(f"infer --dataset: bad result {result}")

        # the card against the CPU plain path on the first 16 clouds
        first = PointCloudDataset("modelnet", raw[:16], np.zeros(16), num_points=N_POINTS).pts
        with torch.no_grad():
            card = ensemble_logits(infer.load_model("DGCNN", ckpt, dev),
                                   torch.from_numpy(first).to(dev)).cpu()
            cpu = ensemble_logits(infer.load_model("DGCNN", ckpt, torch.device("cpu")),
                                  torch.from_numpy(first))
    diff = (card - cpu).abs()
    disagree = int((card.argmax(-1) != cpu.argmax(-1)).sum())
    disagree_infer = int((torch.from_numpy(preds[:16]) != cpu.argmax(-1)).sum())
    print(f"logits card vs CPU (16 clouds, |logit| up to {cpu.abs().max():.3f}): max |diff| "
          f"{diff.max():.3e}, median {diff.median():.3e}; argmax disagrees on {disagree} "
          f"(infer's predictions on {disagree_infer}); classes predicted "
          f"{len(np.unique(preds))}", flush=True)
    if not torch.isfinite(card).all() or diff.max() > MAX_LOGIT_DIFF:
        fail(f"logits differ by {diff.max():.3e} (> {MAX_LOGIT_DIFF})")
    if max(disagree, disagree_infer) > MAX_ARGMAX_DISAGREE:
        fail(f"argmax disagrees on {max(disagree, disagree_infer)} of 16 clouds")

    # 5. times
    print(f"times (CUDA events), card: {smi}", flush=True)
    entry = {"name": "edgeconv_fwd", "route": "cuda",
             "source": "sug_tpu_torch/csrc/edgeconv_fwd.cu",
             "replaces": "sug_tpu/ops/edgeconv_pallas.py:498",
             "launches": launches, "max_abs_err": max_abs_err, "ms": 0.0, "plain_ms": 0.0,
             "bound_ms": 0.0, "library_ms": None, "shapes": []}
    t_ops = 0.0
    for shape in SHAPES:
        args = shape_inputs(shape, gen, dev)
        ms = timed_ms(lambda: edgeconv.edgeconv_reduce(*args), iters=20)
        plain_ms = timed_ms(lambda: edgeconv.edgeconv_reduce_plain(*args), iters=5)
        b_ms, b_by, nbytes, flops = bound(*args)
        t_ops += flops / F32_FLOP_PER_S * 1e3 if b_by == "operations" else 0.0
        print(f"  {shape[0]} (B={B}, S={args[0].shape[1]}, N={N_POINTS}, C={shape[2]}, "
              f"F={shape[3]}, k={shape[4]}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)",
              flush=True)
        entry["shapes"].append({"name": shape[0], "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": b_ms, "bound_by": b_by})
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        entry["bound_ms"] += b_ms
    # the entry is one forward's five calls; say what bounds most of them
    entry["bound_by"] = "operations" if t_ops >= entry["bound_ms"] / 2 else "bytes"

    batch = torch.from_numpy(calib.pts).to(dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fwd_ms = timed_ms(lambda: ensemble_logits(model, batch), iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"forward (NetMDA DGCNN eval, ensemble logits), B={B}, N={N_POINTS}: {fwd_ms:.3f} ms "
          f"per batch, {B / fwd_ms * 1e3:.1f} clouds/s; peak device memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    profile_forward(model, batch, fwd_ms)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
