"""Model and workload configuration of the port.

The fields the selection slice reads, with the values of ssdr_al_tpu's
config.py (reference SSDR_AL_s3dis/helper_tool.py:46-75). The training
fields (batch size, learning-rate schedule, epochs) come with the training
slice. tests/test_torch_data.py holds every field to the JAX config.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    k_n: int = 16                      # KNN neighbourhood size
    num_layers: int = 5                # encoder depth
    num_points: int = 40960            # points per block
    num_classes: int = 13
    sub_sampling_ratio: Tuple[int, ...] = (4, 4, 4, 4, 2)
    d_out: Tuple[int, ...] = (16, 64, 128, 256, 512)
    # morton search window of the big (> 16384-point) pyramid layers before
    # the gather-tile derate (models/randlanet.py); a multiple of 512
    search_window: int = 2048


ConfigS3DIS = Config()
