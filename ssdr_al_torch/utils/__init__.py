"""Logging and timers (utils/logging.py), prediction and label exporters
(utils/visualize.py)."""

from ssdr_al_torch.utils.logging import (  # noqa: F401
    MetricsWriter,
    Timer,
    log_out,
)
