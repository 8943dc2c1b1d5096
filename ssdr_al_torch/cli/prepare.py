"""Dataset preparation CLI: raw archives → PLY artifacts (the counterpart
of ssdr_al_tpu/cli/prepare.py, the same flags and files):

  python -m ssdr_al_torch.cli.prepare --dataset S3DIS \
      --raw ./data/S3DIS/Stanford3dDataset_v1.2_Aligned_Version \
      --out ./data/S3DIS [--device cpu]

The preparation is host work (numpy and scipy, as in JAX). --device is
every port entry point's flag: the default, the card, raises on a machine
without one before anything is written.
"""

from __future__ import annotations

import argparse

from ssdr_al_torch.data.prepare import (
    prepare_s3dis,
    prepare_semantic3d,
    prepare_semantickitti_scan,
)
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description="dataset preparation")
    p.add_argument("--device", type=str, default=DEFAULT_DEVICE,
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--dataset", required=True,
                   choices=["S3DIS", "semantic3d", "SemanticKITTI"])
    p.add_argument("--raw", required=True, help="raw dataset root")
    p.add_argument("--out", required=True, help="output data root (data/<ds>)")
    p.add_argument("--grid_size", type=float, default=0.0,
                   help="0 = dataset default (0.04 S3DIS / 0.06 others)")
    p.add_argument("--keep_ignored", action="store_true",
                   help="semantic3d: keep class-0 (unlabeled) points")
    args = p.parse_args(argv)
    resolve_device(args.device)

    if args.dataset == "S3DIS":
        prepare_s3dis(args.raw, args.out, grid_size=args.grid_size or 0.04)
    elif args.dataset == "semantic3d":
        prepare_semantic3d(args.raw, args.out,
                           grid_size=args.grid_size or 0.06,
                           keep_ignored=args.keep_ignored)
    else:
        import glob
        import os

        grid = args.grid_size or 0.06
        for seq in sorted(glob.glob(os.path.join(args.raw, "*"))):
            pc_dir = os.path.join(seq, "velodyne")
            if not os.path.isdir(pc_dir):
                continue
            for b in sorted(glob.glob(os.path.join(pc_dir, "*.bin"))):
                lab = b.replace("velodyne", "labels").replace(".bin", ".label")
                name = (
                    os.path.basename(seq) + "_" + os.path.basename(b)[:-4]
                )
                prepare_semantickitti_scan(
                    b, lab if os.path.exists(lab) else None,
                    args.out, name, grid_size=grid,
                )
                print("prepared", name)


if __name__ == "__main__":
    main()
