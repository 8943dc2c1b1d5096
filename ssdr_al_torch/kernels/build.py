"""Build and load the port's hand-written CUDA kernels.

Every `ssdr_al_torch/csrc/*.cu` file is compiled by its own `nvcc` for
Hopper (`sm_90a`), all in parallel, and linked into ONE shared library
with a plain C interface, loaded with ctypes. No PyTorch header is
included, so a build takes seconds. The library
lands in `<repo>/build/kernels/` (listed in .gitignore) under a name keyed on
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the cached file. The first call to `library()` builds;
importing this module builds nothing.

Each wrapper (ops/knn.window_topk and knn_tiled, ops/gather.gather_window,
window_transpose and scatter_window, ops/chamfer.chamfer_sums) passes
tensor pointers and the current CUDA stream as ctypes.c_void_p and raises
if the launcher's returned cudaError_t is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# streaming multiprocessors of the H100 SXM the launch plans size grids for
# (ops/knn.py::window_topk_plan, ops/gather.py::gather_plan)
SMS = 132

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every launcher (all return cudaError_t as int)
SIGNATURES = {
    # support, queries, starts, out, B, ns, nq, window, k, tq, centered,
    # split, queries per CTA, threads, self-search, shared bytes, stream
    "window_topk_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _P],
    # support, query, bounds, support codes, query codes, B, ns, nq,
    # self-search, stream
    "knn_codes_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # support, query, support order, query order, support codes, query
    # codes, groups, order, boxes, out, stats, B, ns, nq, k, threads, boxes
    # in shared memory, self-search, shared bytes, stream
    "knn_tiled_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P],
    # support, query, out, B, ns, nq, k, stream (K6's brute-force route)
    "knn_brute_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    # values, idx, starts, out, B, N, nq, k, C, window, tq, slab, rows,
    # threads, bf16 output, unit, stream
    "gather_window_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _P],
    # idx, starts, plan-tile counts, spans and reach, row counts, block
    # counts, rowptr, ids, B, N, nq, k, window, tq, parts, pieces, threads,
    # one CTA a batch element, stream (K4's transpose)
    "scatter_transpose_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # g, idx, starts, counts, bins, ovf, dv, B, N, nq, k, C, window, tq,
    # group, hist, bf16 g, stream (K4's single-use path)
    "scatter_fused_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _P],
    # g, rowptr, ids, dv, B, N, nq, k, C, group, unit, stream (K4's sum)
    "scatter_sum_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # points, mask, packed, counts, out, C, S, P, stream
    "chamfer_sums_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (needs the CUDA toolkit)")
    return cand


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(list(srcs) + list(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel library if the cached build is missing; return it."""
    srcs = _sources()
    out = BUILD_DIR / f"libssdr_kernels_{_digest(srcs)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    # one nvcc per source, all at once; then one host link
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(srcs, objs)]
    logs = [(src.name, p.communicate()[0], p.returncode)
            for src, p in zip(srcs, procs)]
    (BUILD_DIR / "ptxas.log").write_text(
        "".join(f"== {name}\n{text}" for name, text, _ in logs))
    for name, text, rc in logs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {name} ({rc}):\n"
                               f"{text[-4000:]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda(name: str, *tensors: torch.Tensor):
    """Checks shared by the wrappers before a launch."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
