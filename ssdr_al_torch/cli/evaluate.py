"""Standalone evaluation (counterpart of ssdr_al_tpu/cli/evaluate.py): run a
saved snapshot over every point of the validation clouds, write one
prediction PLY per cloud (and Semantic3D .labels files on request), and
report OA / mIoU from the written PLYs:

  python -m ssdr_al_torch.cli.evaluate --synthetic --reg_strength 0.05 \\
      --snapshot data/S3DIS/0.05/saver/seed/snapshots/snap-1 \\
      --out preds/ [--knn_engine pallas] [--device cpu]

The snapshot is a port checkpoint (a state_dict saved by
train.trainer.save_checkpoint). On the card every [1 × N] chunk replays
one captured forward (train/trainer.py::EvalStep); each pending chunk's
probabilities are a copy of its own.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssdr_al_torch.cli.common import add_common_args, setup_experiment
from ssdr_al_torch.data.dataset import SamplingPipeline
from ssdr_al_torch.data.ply import read_ply
from ssdr_al_torch.models.randlanet import RandLANet
from ssdr_al_torch.train.cross_val import score_prediction_plys
from ssdr_al_torch.train.trainer import make_eval_step, restore_checkpoint
from ssdr_al_torch.utils.visualize import (
    export_semantic3d_labels,
    write_prediction_ply,
)


def run_evaluate(args) -> dict:
    """Returns {"oa", "miou", "iou"} of the written predictions."""
    exp = setup_experiment(args)
    cfg = exp.cfg
    model = RandLANet(cfg).to(args.device)
    state = restore_checkpoint(args.snapshot, args.device)
    eval_step = make_eval_step(model, cfg, args.knn_engine, False,
                               device=args.device)

    os.makedirs(args.out, exist_ok=True)
    pipe = SamplingPipeline(exp.val_clouds, cfg)
    for cloud in exp.val_clouds:
        probs_sum = np.zeros((cloud.num_points, cfg.num_classes), np.float32)
        pending = []
        for batch, idx, valid in pipe.cloud_chunks(cloud):
            probs, _ = eval_step(state, batch)
            pending.append((idx, valid, probs))
        for idx, valid, probs in pending:
            probs_sum[idx[:valid]] += probs[0][:valid].cpu().numpy()

        if cloud.proj_idx is not None:
            # sub-cloud votes reprojected to the full-resolution points
            # (RandLANet.py:375-419): predictions and metrics at full
            # resolution
            pred = probs_sum[cloud.proj_idx].argmax(axis=1)
            gt = cloud.full_labels
            xyz = _full_res_xyz(exp.input_path, cloud.name)
            if xyz is None:   # no original_ply/: each point's sub xyz
                xyz = cloud.xyz[cloud.proj_idx]
            proj = cloud.proj_idx
        else:
            pred = probs_sum.argmax(axis=1)
            gt = cloud.labels
            xyz = cloud.xyz
            proj = np.arange(cloud.num_points)
        write_prediction_ply(os.path.join(args.out, cloud.name + ".ply"),
                             xyz, pred, gt)
        if args.export_labels:
            export_semantic3d_labels(
                os.path.join(args.out, cloud.name + ".labels"), probs_sum,
                proj, label_values=np.arange(1, cfg.num_classes + 1))
    result = score_prediction_plys(args.out, cfg.num_classes)
    print(f"OA={result['oa']:.4f} mIoU={result['miou']:.4f} "
          f"IoU={['%.3f' % x for x in result['iou']]}")
    return result


def _full_res_xyz(input_path: str, name: str):
    """xyz of the original (full-resolution) cloud where the preparation
    kept it: original_ply/ beside input_<grid>/."""
    path = os.path.join(os.path.dirname(input_path), "original_ply",
                        name + ".ply")
    if not os.path.exists(path):
        return None
    data = read_ply(path)
    return np.vstack((data["x"], data["y"], data["z"])).T.astype(np.float32)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="standalone evaluation")
    add_common_args(p)
    p.add_argument("--snapshot", required=True)
    p.add_argument("--out", default="./predictions")
    p.add_argument("--export_labels", action="store_true",
                   help="also write Semantic3D-style .labels files")
    return p


def main(argv=None):
    run_evaluate(parser().parse_args(argv))


if __name__ == "__main__":
    main()
