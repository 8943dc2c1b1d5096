"""Superpoint partition CLI, the offline step before the seed round (the
counterpart of ssdr_al_tpu/cli/superpoint.py; flags of
partition/compute_superpoint.py:118-131, plus --device):

  python -m ssdr_al_torch.cli.superpoint --dataset S3DIS --reg_strength 0.008 \\
      --k_nn_geof 45 --k_nn_adj 10 --lambda_edge_weight 1.0 --test_area 5 \\
      [--device cpu] [--knn_backend auto|device|host]

On the card (the default) --knn_backend auto searches the 46-NN graph
with kernel K6 and computes the geometric features there; with --device
cpu, auto is scipy's cKDTree, as JAX's auto is off the TPU. Cut-pursuit
runs on the host (partition/cp.py builds its library with g++ at first
use).
"""

from __future__ import annotations

import argparse

from ssdr_al_torch.cli.common import add_common_args, setup_experiment
from ssdr_al_torch.partition.superpoint import (
    KNN_BACKENDS,
    compute_superpoints,
    superpoint_size_distribution,
)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="superpoint partition")
    add_common_args(p)
    p.add_argument("--k_nn_geof", type=int, default=45)
    p.add_argument("--k_nn_adj", type=int, default=10)
    p.add_argument("--lambda_edge_weight", type=float, default=1.0)
    p.add_argument("--knn_backend", type=str, default="auto",
                   choices=list(KNN_BACKENDS))
    return p


def run_superpoint(args):
    """Partition every training cloud of the experiment and write the
    registry; returns (total.pkl's dict, per-cloud stage times)."""
    exp = setup_experiment(args)
    state = exp.make_state([])
    # synthetic scenes are dense & small: cap the geof neighborhood
    k_geof = min(args.k_nn_geof,
                 max(8, min(c.num_points for c in exp.train_clouds) - 1))
    times = []
    total = compute_superpoints(
        exp.train_clouds, state, args.reg_strength,
        k_adj=args.k_nn_adj, k_geof=k_geof,
        lambda_edge_weight=args.lambda_edge_weight,
        knn_backend=args.knn_backend, device=args.device, times=times,
    )
    dist = superpoint_size_distribution(
        state, [c.name for c in exp.train_clouds])
    print(f"superpoint distribution: sp_count={dist['sp_count']} "
          f"mean_size={dist['mean_size']:.1f}")
    return total, times


def main(argv=None):
    run_superpoint(parser().parse_args(argv))


if __name__ == "__main__":
    main()
