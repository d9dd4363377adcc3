"""Times farthest point sampling and the paths that run it on one CUDA card,
for the ``sug_tpu_torch`` of the checkout at ``--root`` (default: the
checkout this file is in), so that two trees can be compared in one call on
one card, each in its own process, in turns (parent, change, change,
parent):

    python3 sug_tpu_torch/bench_fps.py [--root CHECKOUT] [--label NAME]

It uses only what every tree since the FPS kernel's port has: the
checkout's ``chip_smoke.py`` for its seeded clouds, CUDA-event timer and
synthetic datasets, ``geometry.farthest_point_sample``, the wrapper
``geometry_kernels.fps`` and its launcher ``_launch_fps``, ``NetMDA`` and
``DGTrainer.train_step``. It prints, one line each:

- FPS at B=64 at the main paths' shapes (the SA-node's (N, npoint) =
  (1024, 64) and at 4096 points (4096, 64); PTran's four levels (1024, 256),
  (256, 64), (64, 16), (16, 4); a ragged (1000, 250); (16384, 512)) and at
  B=4 above 16384 points (65536, 64): the call the models make
  (``farthest_point_sample``), the wrapper and the launcher alone, in ms
  from CUDA events after warm-up, and the kernel's device time per launch
  (every kernel whose name holds ``fps_kernel``, from ``torch.profiler``);
  a tree that refuses a shape prints so; and, where the tree's launcher
  takes a team of warps and blocks per cloud, the kernel's device time on
  each team at (4096, 64), (16384, 512) and (65536, 64), the one-block
  designs against the cluster ones;
- the DGCNN, PTran and PointNet DG train steps at 1024 points and the
  PointNet step at 4096 (B=64+64), and the DGCNN, PTran and PointNet
  inference forwards at 1024 points (B=64), each in ms from CUDA events
  after warm-up with the device's busy share (``torch.profiler`` kernel time
  over the CUDA-event time), its kernels per call (every kernel
  ``torch.profiler`` saw), its peak of allocated memory and its FPS
  launches per call;

then one JSON line of them all (ms, busy shares and launch counts by name)
with the card's name and power limit. It
needs a card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

# (B, N, npoint): the SA-node at 1024 and 4096 points, PTran's four
# TransitionDowns, a ragged cloud, the largest one-block cloud, a cluster
FPS_SHAPES = [(64, 1024, 64), (64, 1024, 256), (64, 256, 64), (64, 64, 16), (64, 16, 4),
              (64, 1000, 250), (64, 4096, 64), (64, 16384, 512), (4, 65536, 64)]
# the FPS kernel's teams (warps per block, blocks per cloud) compared
TEAMS = [(w, c) for c in (1, 2, 4, 8) for w in (4, 8, 16, 32)]
SOURCES = ("edgeconv_fwd", "edgeconv_bwd", "vecattn_fwd", "vecattn_bwd", "chamfer_min", "fps")


def device_ms(fn, torch, key, iters=3):
    """Device time per call of ``fn`` in kernels whose name holds ``key``
    (all kernels for ``key=None``), from torch.profiler over ``iters``
    calls, and the launches per call of those kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and (key is None or key in e.key)]
    return (sum(e.self_device_time_total for e in rows) / 1e3 / iters,
            sum(e.count for e in rows) / iters)


def main() -> None:
    default_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=default_root, help="the checkout to time")
    ap.add_argument("--label", default="tree", help="a name for this tree in the output")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path[0] = root  # the checkout, not this file's directory

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_fps: torch.cuda.is_available() is False: needs a CUDA card")
    cs = importlib.import_module("chip_smoke")
    from sug_tpu_torch.data.datasets import PointCloudDataset
    from sug_tpu_torch.engine.dg_trainer import DGTrainer
    from sug_tpu_torch.models.net_mda import NetMDA, ensemble_logits
    from sug_tpu_torch.ops import cuda_build
    from sug_tpu_torch.ops import geometry_kernels as gk
    from sug_tpu_torch.ops.geometry import farthest_point_sample
    from sug_tpu_torch.utils.config import parser_config

    for mod in (cs, gk):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            sys.exit(f"bench_fps: imported {mod.__file__}, not from {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"[{opts.label}] card: {smi}; root {root}", flush=True)
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(cuda_build.build, SOURCES))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def record(name, value, note=""):
        times[name] = value
        shown = "refused" if value is None else f"{value:.4f} ms"
        print(f"[{opts.label}] {name}: {shown}{note}", flush=True)

    for b, n, npoint in FPS_SHAPES:
        xyz = cs.unit_clouds(b, n, gen, dev)
        starts = torch.randint(0, n, (b,), generator=gen, device=dev)
        name = f"fps B={b} N={n} npoint={npoint}"
        try:
            gk._launch_fps(xyz, npoint, starts)
            torch.cuda.synchronize()
        except RuntimeError as e:  # a cloud the tree's launcher refuses
            print(f"[{opts.label}] {name}: the launcher refuses it: {e}", flush=True)
            for what in ("call", "wrapper", "launcher", "kernel device"):
                times[f"{name} {what}"] = None
            continue
        iters = 20 if n * npoint <= 1 << 20 else 5
        routed_iters = iters if n >= 4096 else 3  # below 4096 points the parent loops in PyTorch
        record(f"{name} call", cs.timed_ms(lambda: farthest_point_sample(xyz, npoint, starts),
                                           iters=routed_iters))
        record(f"{name} wrapper", cs.timed_ms(lambda: gk.fps(xyz, npoint, starts), iters=iters))
        record(f"{name} launcher", cs.timed_ms(lambda: gk._launch_fps(xyz, npoint, starts),
                                               iters=iters))
        ms, _ = device_ms(lambda: gk._launch_fps(xyz, npoint, starts), torch, "fps_kernel")
        record(f"{name} kernel device", ms, f" ({ms / npoint * 1e3:.3f} us per step)")
        del xyz, starts

    # the kernel's teams (warps, cluster) at the one-block and the cluster
    # sizes, where the tree's launcher takes a team (the FPS kernel of the
    # parent tree has one design)
    if "plan" in inspect.signature(gk._launch_fps).parameters:
        for b, n, npoint in ((64, 4096, 64), (64, 16384, 512), (4, 65536, 64)):
            xyz = cs.unit_clouds(b, n, gen, dev)
            starts = torch.randint(0, n, (b,), generator=gen, device=dev)
            want = gk._launch_fps(xyz, npoint, starts)
            for plan in TEAMS:
                name = f"fps B={b} N={n} npoint={npoint} team {plan}"
                try:
                    got = gk._launch_fps(xyz, npoint, starts, plan)
                    torch.cuda.synchronize()
                except RuntimeError:  # more points a thread than the launcher takes
                    continue
                if not torch.equal(got, want):
                    sys.exit(f"bench_fps: {name} gives other indices than fps_plan's team")
                ms, _ = device_ms(lambda: gk._launch_fps(xyz, npoint, starts, plan), torch,
                                  "fps_kernel")
                record(f"{name} kernel device", ms, f" ({ms / npoint * 1e3:.3f} us per step, "
                       f"{gk.fps_points_per_thread(n, *plan)} points a thread)")
            del xyz, starts

    def path(name, fn, iters):
        """A step or forward: CUDA-event ms, busy share, kernels per call,
        peak allocated MiB, FPS launches per call."""
        ms = cs.timed_ms(fn, iters=iters)
        busy, kernels = device_ms(fn, torch, None, iters=2)
        gk.fps.launches = 0
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        launches, peak = gk.fps.launches, torch.cuda.max_memory_allocated() / 2**20
        record(name, ms, f" (device busy {busy:.3f} ms, {busy / ms:.1%}; {kernels:.1f} kernels "
               f"a call; peak {peak:.1f} MiB; {launches} FPS kernel launches a call)")
        times[f"{name} busy share"] = busy / ms
        times[f"{name} kernels"] = kernels
        times[f"{name} peak MiB"] = peak
        times[f"{name} fps launches"] = launches

    rng = np.random.default_rng(0)
    _, dgcnn_cfg = parser_config(["--cfg", cs.YAML, "--set", "Model", "DGCNN"])
    _, ptran_cfg = parser_config(["--cfg", cs.YAML, "--set", "Model", "PTran"])
    _, pn_cfg = parser_config(["--cfg", cs.YAML])
    lrs = (1e-4, 1e-4, 1e-4)
    for model_name, cfg, n, iters in (("DGCNN", dgcnn_cfg, cs.N_POINTS, 5),
                                      ("PTran", ptran_cfg, cs.N_POINTS, 3),
                                      ("Pointnet", pn_cfg, cs.N_POINTS, 5),
                                      ("Pointnet", pn_cfg, cs.N_LARGE, 5)):
        clouds, labels = cs.synthetic_clouds(rng, 2 * cs.B, n)
        clouds = PointCloudDataset("modelnet", clouds, labels, num_points=n).pts
        step = [torch.from_numpy(a).to(dev) for a in
                (clouds[:cs.B], labels[:cs.B], clouds[cs.B:], labels[cs.B:])]
        trainer = DGTrainer(cfg, model_name=model_name, device=dev, seed=0, num_points=n)
        path(f"{model_name} DG train step N={n}", lambda: trainer.train_step(*step, *lrs), iters)
        del trainer, step
    for model_name, seed, iters in (("DGCNN", 0, 10), ("PTran", 2, 5), ("Pointnet", 4, 10)):
        torch.manual_seed(seed)
        model = NetMDA(model_name, num_points=cs.N_POINTS)
        cs.randomize_bn(model, torch.Generator().manual_seed(seed + 1))
        model = model.eval().to(dev)
        batch = torch.from_numpy(PointCloudDataset(
            "modelnet", cs.synthetic_clouds(rng, cs.B)[0], np.zeros(cs.B),
            num_points=cs.N_POINTS).pts).to(dev)
        with torch.no_grad():
            path(f"{model_name} forward N={cs.N_POINTS}", lambda: ensemble_logits(model, batch),
                 iters)
        del model, batch
    print(json.dumps({"label": opts.label, "card": smi, "results": times}), flush=True)


if __name__ == "__main__":
    main()
