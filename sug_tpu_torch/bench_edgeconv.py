"""Times the EdgeConv kernels and the DG train steps that run them on one
CUDA card, for the ``sug_tpu_torch`` of the checkout at ``--root`` (default:
the checkout this file is in), so that two trees can be compared in one
call on one card, each in its own process, in turns (parent, change,
change, parent):

    python3 sug_tpu_torch/bench_edgeconv.py [--root CHECKOUT] [--label NAME]

It uses only what every tree since the EdgeConv backward's port has: the
checkout's ``chip_smoke.py`` for its seeded inputs, bound and CUDA-event
timer, ``edgeconv_reduce``, ``edgeconv_reduce_plain``,
``edgeconv_reduce_bwd`` and ``DGTrainer.train_step``. It prints, one line
each, the backward (one call) at DGCNN's five N=1024 shapes and at the
N=4096 shapes (blocks 1 and 4, the SA-node, and block 1 on a zero-padded
cloud); the forward (one call) at the five N=1024 shapes, at the five
N=4096 shapes and at block 1 on a zero-padded N=4096 cloud, each beside
its bound, its plain version's time and its device time by kernel (every
kernel whose name holds ``edgeconv_fwd``, from ``torch.profiler``); and
the DGCNN DG train step at 1024 and 4096 points and the PointNet step at
4096 (B=64+64), in ms from CUDA events after warm-up; then one JSON line of
them all with the card's name and power limit. It needs a card and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys


def kernel_ms(fn, torch, iters=3):
    """Device time per launch of each kernel whose name holds
    ``edgeconv_fwd``, over ``iters`` calls of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "edgeconv_fwd" in e.key and e.count}


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
        sys.exit("bench_edgeconv: torch.cuda.is_available() is False: needs a CUDA card")
    cs = importlib.import_module("chip_smoke")
    from sug_tpu_torch.data.datasets import PointCloudDataset
    from sug_tpu_torch.engine.dg_trainer import DGTrainer
    from sug_tpu_torch.ops import edgeconv
    from sug_tpu_torch.utils.config import parser_config

    for mod in (cs, edgeconv):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            sys.exit(f"bench_edgeconv: imported {mod.__file__}, not from {root}")
    cs.edgeconv = edgeconv  # chip_smoke's helpers call the module it names
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"[{opts.label}] card: {smi}; root {root}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def record(name, ms, note=""):
        times[name] = ms
        print(f"[{opts.label}] {name}: {ms:.4f} ms{note}", flush=True)

    def forward(name, fwd_args, iters):
        ms = cs.timed_ms(lambda: edgeconv.edgeconv_reduce(*fwd_args), iters=iters)
        plain_ms = cs.timed_ms(lambda: edgeconv.edgeconv_reduce_plain(*fwd_args), iters=1,
                               warmup=1)
        b_ms, b_by = cs.bound(*fwd_args)[:2]
        split = kernel_ms(lambda: edgeconv.edgeconv_reduce(*fwd_args), torch)
        record(f"forward {name}", ms, f" (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
               "device ms per launch: " + ", ".join(f"{k} {t:.4f}" for k, t in split.items()) + ")")

    cases = [(s[0], s, cs.N_POINTS, None) for s in cs.SHAPES]
    cases += [(f"{s[0]} N={cs.N_LARGE}", s, cs.N_LARGE, None) for s in cs.LARGE_SHAPES]
    cases.append((f"block1 N={cs.N_LARGE} zero-padded", cs.SHAPES[0], cs.N_LARGE, 2048))
    for name, shape, n, real in cases:
        fwd_args = cs.shape_inputs(shape, gen, dev, n, real=real)
        args = cs.bwd_inputs(*fwd_args, gen)
        record(f"backward {name}", cs.timed_ms(lambda: edgeconv.edgeconv_reduce_bwd(*args),
                                               iters=10 if n == cs.N_POINTS else 5))
        if n == cs.N_POINTS:
            forward(name, fwd_args, iters=10)
        del fwd_args, args
    for shape, real in [(s, None) for s in cs.SHAPES] + [(cs.SHAPES[0], 2048)]:
        fwd_args = cs.shape_inputs(shape, gen, dev, cs.N_LARGE, real=real)
        name = f"{shape[0]} N={cs.N_LARGE}" + ("" if real is None else " zero-padded")
        forward(name, fwd_args, iters=3)
        del fwd_args

    rng = np.random.default_rng(0)
    _, dgcnn_cfg = parser_config(["--cfg", cs.YAML, "--set", "Model", "DGCNN"])
    _, pn_cfg = parser_config(["--cfg", cs.YAML])
    lrs = (1e-4, 1e-4, 1e-4)
    for model_name, cfg, n, iters in (("DGCNN", dgcnn_cfg, cs.N_POINTS, 5),
                                      ("DGCNN", dgcnn_cfg, cs.N_LARGE, 3),
                                      ("Pointnet", pn_cfg, cs.N_LARGE, 5)):
        clouds, labels = cs.synthetic_clouds(rng, 2 * cs.B, n)
        clouds = PointCloudDataset("modelnet", clouds, labels, num_points=n).pts
        step = [torch.from_numpy(a).to(dev) for a in
                (clouds[:cs.B], labels[:cs.B], clouds[cs.B:], labels[cs.B:])]
        trainer = DGTrainer(cfg, model_name=model_name, device=dev, seed=0, num_points=n)
        record(f"{model_name} DG train step N={n}",
               cs.timed_ms(lambda: trainer.train_step(*step, *lrs), iters=iters))
        del trainer, step
    print(json.dumps({"label": opts.label, "card": smi, "times_ms": times}), flush=True)


if __name__ == "__main__":
    main()
