"""The offline superpoint partition (the counterpart of
ssdr_al_tpu/partition/): KNN graphs (K6 on the card), geometric features,
L0 cut-pursuit (native C++ through ctypes), the superpoint graph and its
HDF5 files, and the raw-format readers and PLY exporters."""

from ssdr_al_torch.partition.cp import connected_components, cutpursuit  # noqa: F401
from ssdr_al_torch.partition.superpoint import (  # noqa: F401
    compute_superpoints,
    partition_cloud,
)
