"""Times the EdgeConv kernels and the DG train steps that run them on one
CUDA card, for the ``sug_tpu_torch`` of the checkout at ``--root`` (default:
the checkout this file is in), so that two trees can be compared in one
call on one card, each in its own process, in turns (parent, change,
change, parent):

    python3 sug_tpu_torch/bench_edgeconv_bwd.py [--root CHECKOUT] [--label NAME]

It uses only what every tree since the EdgeConv backward's port has: the
checkout's ``chip_smoke.py`` for its seeded inputs and CUDA-event timer,
``edgeconv_reduce``, ``edgeconv_reduce_bwd`` and ``DGTrainer.train_step``.
It prints, one line each, the backward (one call) at DGCNN's five N=1024
shapes and at the N=4096 shapes (blocks 1 and 4, the SA-node, and block 1
on a zero-padded cloud), the forward at the five N=1024 shapes, and the
DGCNN DG train step at 1024 and 4096 points and the PointNet step at 4096
(B=64+64), in ms from CUDA events after warm-up; then one JSON line of
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
        sys.exit("bench_edgeconv_bwd: torch.cuda.is_available() is False: needs a CUDA card")
    cs = importlib.import_module("chip_smoke")
    from sug_tpu_torch.data.datasets import PointCloudDataset
    from sug_tpu_torch.engine.dg_trainer import DGTrainer
    from sug_tpu_torch.ops import edgeconv
    from sug_tpu_torch.utils.config import parser_config

    for mod in (cs, edgeconv):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            sys.exit(f"bench_edgeconv_bwd: imported {mod.__file__}, not from {root}")
    cs.edgeconv = edgeconv  # chip_smoke's helpers call the module it names
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"[{opts.label}] card: {smi}; root {root}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {}

    def record(name, ms):
        times[name] = ms
        print(f"[{opts.label}] {name}: {ms:.4f} ms", flush=True)

    cases = [(s[0], s, cs.N_POINTS, None) for s in cs.SHAPES]
    cases += [(f"{s[0]} N={cs.N_LARGE}", s, cs.N_LARGE, None) for s in cs.LARGE_SHAPES]
    cases.append((f"block1 N={cs.N_LARGE} zero-padded", cs.SHAPES[0], cs.N_LARGE, 2048))
    for name, shape, n, real in cases:
        fwd_args = cs.shape_inputs(shape, gen, dev, n, real=real)
        args = cs.bwd_inputs(*fwd_args, gen)
        record(f"backward {name}", cs.timed_ms(lambda: edgeconv.edgeconv_reduce_bwd(*args),
                                               iters=10 if n == cs.N_POINTS else 5))
        if n == cs.N_POINTS:
            record(f"forward {name}",
                   cs.timed_ms(lambda: edgeconv.edgeconv_reduce(*fwd_args), iters=10))
        del fwd_args, args

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
