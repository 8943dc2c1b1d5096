"""Model and workload configuration of the port.

The fields of ssdr_al_tpu's config.py that the port reads, with its
S3DIS, Semantic3D and SemanticKITTI values (reference
SSDR_AL_s3dis/helper_tool.py:18-117), and the inverse-frequency class
weights (helper_tool.py:264-284).
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
    # --- numerics ---
    compute_dtype: str = "float32"     # activations: "float32" | "bfloat16"
    # morton search window of the big (> 16384-point) pyramid layers before
    # the gather-tile derate (models/randlanet.py); a multiple of 512
    search_window: int = 2048
    # space-filling curve the window engines sort along: "morton" or
    # "hilbert" (a key of ops.knn.CURVES)
    curve: str = "morton"
    # --- AL loop ---
    sp_batch_size: int = 10000         # superpoint clicks per round
    al_rounds: Tuple[int, int] = (2, 33)


# reference helper_tool.py:46-75
ConfigS3DIS = Config()

# reference helper_tool.py:77-117
ConfigSemantic3D = Config(
    name="Semantic3D", num_points=65536, num_classes=8, sub_grid_size=0.06,
    ignored_label_inds=(0,), batch_size=4, val_batch_size=16, max_epoch=50,
    lr_decay=0.9, eval_start_frac=0.6, sp_batch_size=3000)

# reference helper_tool.py:18-44
ConfigSemanticKITTI = Config(
    name="SemanticKITTI", num_layers=4, num_points=4096 * 11, num_classes=19,
    sub_grid_size=0.06, sub_sampling_ratio=(4, 4, 4, 4),
    d_out=(16, 64, 128, 256), ignored_label_inds=(0,), max_epoch=100,
    lr_decay=0.95)

_CONFIGS = {
    "S3DIS": ConfigS3DIS,
    "Semantic3D": ConfigSemantic3D,
    "semantic3d": ConfigSemantic3D,
    "SemanticKITTI": ConfigSemanticKITTI,
}


def get_config(name: str) -> Config:
    try:
        return _CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; options: "
                       f"{sorted(_CONFIGS)}") from None


# per-class point counts of the inverse-frequency CE weights
CLASS_COUNTS = {
    "S3DIS": (
        3370714, 2856755, 4919229, 318158, 375640, 478001, 974733,
        650464, 791496, 88727, 1284130, 229758, 2272837,
    ),
    "Semantic3D": (
        5181602, 5012952, 6830086, 1311528, 10476365, 946982, 334860, 269353,
    ),
    "SemanticKITTI": (
        55437630, 320797, 541736, 2578735, 3274484, 552662, 184064, 78858,
        240942562, 17294618, 170599734, 6369672, 230413074, 101130274,
        476491114, 9833174, 129609852, 4506626, 1168181,
    ),
}


def class_weights(name: str) -> np.ndarray:
    """ce_label_weight = 1 / (class_frequency + 0.02), float32."""
    counts = np.asarray(CLASS_COUNTS[name], dtype=np.float64)
    freq = counts / counts.sum()
    return (1.0 / (freq + 0.02)).astype(np.float32)


# S3DIS label names; reference s3dis_dataset.py:32-44.
S3DIS_LABELS = (
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
)
