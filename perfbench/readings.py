"""The readings the limits of ``correct`` are set from, in one process per
cell (the benchmark's own runs never run this):

    python3 -m perfbench.readings --workload <cell> --seeds 1,2,3 \\
        --what program|control [--use-bf16] [--seconds 3]

- ``program``: a short window of the cell per seed and the numbers its
  comparison reads (the lower readings);
- ``control``: the reference in the nearest precision below the
  configuration's, put in the program's place, on the frames or steps a
  run of that seed would compare (the upper readings);
- ``--use-bf16``: either, with the configuration's ``use_bf16`` switched
  on (the fault of the bfloat16 path, PERF.md);
- ``--patch``: the program's numbers with a fault planted (the upper
  readings a training cell's faults give).

One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from perfbench import generate, run
from perfbench.reference import compare
from perfbench.reference import host as ref_host
from perfbench.reference import model as R
from perfbench.reference import nms


def control_numbers(name: str, seed: int, device: str = "cuda",
                    overrides: Optional[Dict] = None) -> Dict[str, float]:
    """The control's numbers for ``seed``: the reference rounded to the
    precision below the configuration's, judged as the program is."""
    cell = run.load_cell(name, overrides)
    dev = torch.device(device)
    cfg = run.port_config(cell)
    rc = run.ref_config(cfg)
    with_images = cell.config["with_images"]
    params = run.ref_params(cfg, R.make_params(R.param_spec(with_images),
                                               seed, dev))
    mix = cell.traffic
    pool = generate.make_pool(seed, mix, cfg.velo_range, cfg.image_size,
                              cfg.car_size)
    quant = compare.control_rounding(run.compute_dtype(cell))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mix["loop"] in ("train", "train_dp"):
        arrays = run.train_pool(cell, cfg, pool, seed)
        # a data-parallel cell's global batch spans its cards
        width = cell.chips if mix["loop"] == "train_dp" else 1
        batches = run.ref_batches(arrays, mix["check_steps"],
                                  mix["batch"] * width, dev)
        from perfbench.reference import train as ref_train

        losses, grad, change = ref_train.train_steps(params, batches, rc,
                                                     quant)
        ref_losses, ref_grad, ref_change = ref_train.train_steps(
            params, batches, rc)
        return compare.train_numbers(
            losses, ref_losses, compare.norms(grad),
            compare.norms(ref_grad), compare.norms(change),
            compare.norms(ref_change))
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0xC0DE])
    n = min(mix["check_frames"], len(pool))
    picks = set(rng.choice(len(pool), size=n, replace=False).tolist())
    picks.add(int(np.argmax([len(f.scan) for f in pool])))
    anchors = R.anchors(rc["voxel_shape"], rc["velo_range"],
                        rc["car_size"], dev)
    served, refs = [], []
    for idx in sorted(picks):
        f = pool[idx]
        pts, nreal = ref_host.assemble(f.scan, f.camera.rect, f.camera.proj,
                                       rc["velo_range"], rc["image_size"],
                                       rc["max_points"])
        image = torch.from_numpy(f.image).to(dev) if with_images else None
        p = torch.from_numpy(pts).to(dev)
        with torch.no_grad():
            ref = R.forward_frame(p, nreal, image, params, rc)
            ctl = R.forward_frame(p, nreal, image, params, rc, quant)
        served.append(tuple(t.cpu().numpy() for t in nms.detections(
            *ctl, anchors, run.post_of(mix))))
        refs.append(ref)
    return compare.serve_numbers(served, refs, anchors, run.post_of(mix))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("program", "control"),
                    default="program")
    ap.add_argument("--use-bf16", action="store_true",
                    help="switch the configuration's use_bf16 on (the "
                         "fault of the bfloat16 path, PERF.md)")
    ap.add_argument("--patch", default="",
                    help="a fault to plant in the program, module:function "
                         "returning a context manager (e.g. "
                         "perfbench.tests.test_faults:exchange_left_out)")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    over = {"config": {"use_bf16": True}} if args.use_bf16 else {}
    if args.patch:
        over["patch"] = args.patch
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.what == "control":
            numbers = control_numbers(args.workload, seed, overrides=over)
        else:
            numbers = run.run_once(args.workload, seed, args.seconds, False,
                                   overrides=over)[1]
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "use_bf16": args.use_bf16, "patch": args.patch,
                          "seed": seed, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
