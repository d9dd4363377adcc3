"""Times the vector-attention kernels and the PTran paths that run them on one
CUDA card, for the ``sug_tpu_torch`` of the checkout at ``--root`` (default:
the checkout this file is in), so that two trees can be compared in one call
on one card, each in its own process, in turns (parent, change, change,
parent):

    python3 sug_tpu_torch/bench_vecattn.py [--root CHECKOUT] [--label NAME]

It uses only what every tree since the vector-attention kernels' tensor-core
redesign has: the checkout's ``chip_smoke.py`` for its seeded inputs,
CUDA-event timer and synthetic clouds, ``bench_fps.device_ms``, the
wrappers ``vector_attention_fwd`` and ``vector_attention_bwd``, ``NetMDA``
and ``DGTrainer.train_step``. It prints, one line each:

- each vector-attention kernel instance the tree builds: its number of SASS
  instructions and a hash of them without their addresses
  (``cuobjdump -sass``), so that two trees' instances can be told equal;
- the forward and the backward (fed one forward launch) at the five PTran
  levels at B=64 (``chip_smoke.VA_SHAPES``), in ms from CUDA events after
  warm-up, and their sums over the levels;
- the PTran DG train step at B=64+64 and the inference forward at B=64, 1024
  points, each with its device busy share, kernels a call and peak of
  allocated memory;

in f32, and, where the tree has the bf16 mode (PTran under the bf16
policy), again in it (q, key and val in bf16; the model's compute dtype
bf16); then one JSON line of them all with the card's name and power limit.
It needs a card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import re
import subprocess
import sys


def sass_digests(cuobjdump, library):
    """{mangled kernel name: (instructions, sha256 of them)} of ``library``'s
    SASS, each instruction without its address."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    found, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            found[name] = []
        elif name is not None:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if m:
                found[name].append(m.group(1).strip())
    return {n: (len(ins), hashlib.sha256("\n".join(ins).encode()).hexdigest()[:16])
            for n, ins in found.items()}


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
        sys.exit("bench_vecattn: torch.cuda.is_available() is False: needs a CUDA card")
    cs = importlib.import_module("chip_smoke")
    from sug_tpu_torch.bench_fps import device_ms
    from sug_tpu_torch.data.datasets import PointCloudDataset
    from sug_tpu_torch.engine.dg_trainer import DGTrainer
    from sug_tpu_torch.models.net_mda import NetMDA, ensemble_logits
    from sug_tpu_torch.ops import cuda_build
    from sug_tpu_torch.ops import vector_attention as va
    from sug_tpu_torch.utils.config import parser_config

    for mod in (cs, va):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            sys.exit(f"bench_vecattn: imported {mod.__file__}, not from {root}")
    cs.vector_attention = va
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"[{opts.label}] card: {smi}; root {root}", flush=True)
    cuobjdump = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    sass = {}
    for source in ("vecattn_fwd", "vecattn_bwd", "fps"):
        built = cuda_build.build(source)
        if source != "fps":
            for name, (count, digest) in sass_digests(cuobjdump, built.path).items():
                short = name.split("_cu_", 1)[-1][10:]  # past the file's hash
                sass[short] = digest
                print(f"[{opts.label}] sass {short}: {count} instructions, sha256 {digest}",
                      flush=True)
    dev = torch.device("cuda")
    times = {}

    def record(name, value, note=""):
        times[name] = value
        print(f"[{opts.label}] {name}: {value:.4f} ms{note}", flush=True)

    policies = ["f32"] + (["bf16"] if hasattr(va, "bf16_weights") else [])
    for policy in policies:
        gen = torch.Generator(device=dev).manual_seed(0)
        fwd_sum = bwd_sum = 0.0
        for name, n, k in cs.VA_SHAPES:
            args = cs.va_inputs(n, gen, dev)
            if policy == "bf16":
                args = [a.to(torch.bfloat16) if i in (1, 2, 3) else a for i, a in enumerate(args)]
            fwd = cs.timed_ms(lambda: va.vector_attention_fwd(*args, k), iters=5)
            saved = cs.va_bwd_saved(args, k, gen)
            bwd = cs.timed_ms(lambda: va.vector_attention_bwd(*args, k, *saved), iters=3,
                              warmup=1)
            record(f"{policy} forward {name}", fwd)
            record(f"{policy} backward {name}", bwd)
            fwd_sum, bwd_sum = fwd_sum + fwd, bwd_sum + bwd
            del args, saved
        record(f"{policy} forward, five levels", fwd_sum)
        record(f"{policy} backward, five levels", bwd_sum)

    def path(name, fn, iters):
        ms = cs.timed_ms(fn, iters=iters)
        busy, kernels = device_ms(fn, torch, None, iters=2)
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        record(name, ms, f" (device busy {busy:.3f} ms, {busy / ms:.1%}; {kernels:.1f} kernels "
               f"a call; peak {peak:.1f} MiB)")
        times[f"{name} busy share"] = busy / ms
        times[f"{name} kernels"] = kernels
        times[f"{name} peak MiB"] = peak

    rng = np.random.default_rng(0)
    _, cfg = parser_config(["--cfg", cs.YAML, "--set", "Model", "PTran"])
    clouds, labels = cs.synthetic_clouds(rng, 2 * cs.B, cs.N_POINTS)
    clouds = PointCloudDataset("modelnet", clouds, labels, num_points=cs.N_POINTS).pts
    step = [torch.from_numpy(a).to(dev) for a in
            (clouds[:cs.B], labels[:cs.B], clouds[cs.B:], labels[cs.B:])]
    trainer = DGTrainer(cfg, model_name="PTran", device=dev, seed=0, num_points=cs.N_POINTS)
    torch.manual_seed(2)
    model = NetMDA("PTran", num_points=cs.N_POINTS)
    cs.randomize_bn(model, torch.Generator().manual_seed(3))
    model = model.eval().to(dev)
    batch = step[0]
    for policy in policies:
        dtype = torch.bfloat16 if policy == "bf16" else None
        trainer.model.set_compute_dtype(dtype)
        model.set_compute_dtype(dtype)
        path(f"{policy} PTran DG train step N={cs.N_POINTS}",
             lambda: trainer.train_step(*step, 1e-4, 1e-4, 1e-4), 3)
        with torch.no_grad():
            path(f"{policy} PTran forward N={cs.N_POINTS}", lambda: ensemble_logits(model, batch),
                 5)
    print(json.dumps({"label": opts.label, "card": smi, "results": times, "sass": sass}),
          flush=True)


if __name__ == "__main__":
    main()
