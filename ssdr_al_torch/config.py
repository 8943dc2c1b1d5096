"""Model and workload configuration of the port.

The fields of ssdr_al_tpu's config.py that the selection and training
slices read, with its S3DIS values (reference SSDR_AL_s3dis/helper_tool.py:
46-75), and the inverse-frequency class weights (helper_tool.py:264-284).
Copied, never imported: the port imports nothing of ssdr_al_tpu.
tests/test_torch_data.py holds every field to the JAX config.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "S3DIS"
    # --- model / neighbourhood ---
    k_n: int = 16                      # KNN neighbourhood size
    num_layers: int = 5                # encoder depth
    num_points: int = 40960            # points per block
    num_classes: int = 13
    sub_grid_size: float = 0.04        # preprocessing voxel size
    sub_sampling_ratio: Tuple[int, ...] = (4, 4, 4, 4, 2)
    d_out: Tuple[int, ...] = (16, 64, 128, 256, 512)
    ignored_label_inds: Tuple[int, ...] = ()
    # --- training ---
    batch_size: int = 6
    val_batch_size: int = 20
    train_steps: int = 500             # steps per epoch
    val_steps: int = 100
    max_epoch: int = 30
    learning_rate: float = 1e-2
    lr_decay: float = 0.84             # per-epoch multiplicative decay
    noise_init: float = 3.5            # centre-pick noise (σ = noise_init/10)
    eval_start_frac: float = 0.4       # evaluate after this share of epochs
    # morton search window of the big (> 16384-point) pyramid layers before
    # the gather-tile derate (models/randlanet.py); a multiple of 512
    search_window: int = 2048
    # space-filling curve the window engines sort along: "morton" or
    # "hilbert" (a key of ops.knn.CURVES)
    curve: str = "morton"
    # --- AL loop ---
    sp_batch_size: int = 10000         # superpoint clicks per round
    al_rounds: Tuple[int, int] = (2, 33)


ConfigS3DIS = Config()

_CONFIGS = {"S3DIS": ConfigS3DIS}


def get_config(name: str) -> Config:
    """The dataset's configuration; only S3DIS is ported (ROADMAP.md)."""
    if name not in _CONFIGS:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ROADMAP.md); "
            f"options: {sorted(_CONFIGS)}")
    return _CONFIGS[name]


# per-class point counts of the inverse-frequency CE weights
CLASS_COUNTS = {
    "S3DIS": (
        3370714, 2856755, 4919229, 318158, 375640, 478001, 974733,
        650464, 791496, 88727, 1284130, 229758, 2272837,
    ),
}


def class_weights(name: str) -> np.ndarray:
    """ce_label_weight = 1 / (class_frequency + 0.02), float32."""
    counts = np.asarray(CLASS_COUNTS[name], dtype=np.float64)
    freq = counts / counts.sum()
    return (1.0 / (freq + 0.02)).astype(np.float32)
