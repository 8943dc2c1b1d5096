"""Data parallelism: one rank per device over torch.distributed
(counterpart of ssdr_al_tpu/parallel/)."""

from ssdr_al_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    backend_for,
    data_devices,
    launch,
)
