"""Observability: phase timers, a metrics stream, logging and a device
trace (counterpart of ssdr_al_tpu/utils/logging.py).

`log_out`, `Timer` and `MetricsWriter` are copies of the JAX package's:
costTime deltas, and a JSONL scalar stream in place of the reference's
TensorBoard writer (RandLANet.py:86-103). `device_trace` records a region
with torch.profiler (host ops and, on a card, its kernels) where JAX's
recorded a jax.profiler trace, and writes one Chrome trace file under
`log_dir`.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


def log_out(msg: str, f=None):
    """Append+flush+print (RandLANet.py:13-16)."""
    if f is not None:
        f.write(msg + "\n")
        f.flush()
    print(msg)


class Timer:
    """with Timer() as t: ...; t.seconds — the costTime pattern."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False


class MetricsWriter:
    """Append-only JSONL scalar stream (lr/loss/accuracy/mIoU per
    step/round), the role of the reference's tf.summary.FileWriter
    (RandLANet.py:100-103)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, step: int, **scalars):
        rec = {"step": int(step)}
        for k, v in scalars.items():
            rec[k] = float(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


TRACE_FILE = "trace_{pid}_{stamp}.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Record the region under torch.profiler (host ops, and the card's
    kernels where CUDA is available) when log_dir is set, and write it as
    one Chrome trace file under log_dir (TRACE_FILE); the path is left in
    `device_trace.last_path`. A no-op for None or ""."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, TRACE_FILE.format(
            pid=os.getpid(), stamp=time.strftime("%Y%m%d_%H%M%S")))
        prof.export_chrome_trace(path)
        device_trace.last_path = path


device_trace.last_path = None
