"""GT-database build CLI:

    python -m mvxnet_makise_tpu_torch.tools.create_gtdatabase <dataroot>
        [--kins-json PATH] [--classes C ...] [--limit N] [--config FILE]
        [--device cuda|cpu]

Port of ``mvxnet_makise_tpu/tools/create_gtdatabase.py``
(``data/gt_database.build_database``).  Without ``--kins-json`` the
objects are cut out with rectangular masks from the KITTI 2D boxes.  The
build is host work; like every tool of the port it checks ``--device``
(default the CUDA card) and raises without one unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mvxnet_makise_tpu_torch.tools.create_gtdatabase")
    p.add_argument("dataroot")
    p.add_argument("--kins-json", default=None,
                   help="KINS update_train_2020.json path; omit for "
                        "rectangular masks")
    p.add_argument("--classes", nargs="+",
                   default=["Car", "Pedestrian", "Cyclist"])
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from mvxnet_makise_tpu_torch.config import load_config
    from mvxnet_makise_tpu_torch.data.gt_database import build_database
    from mvxnet_makise_tpu_torch.device import resolve_device

    resolve_device(args.device)
    cfg = load_config(args.config, data_root=args.dataroot)
    counts = build_database(args.dataroot, cfg, kins_json=args.kins_json,
                            classes=tuple(args.classes), limit=args.limit)
    print("gt database built:", counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
