"""ctypes bindings of the native cut-pursuit library (the counterpart of
ssdr_al_tpu/partition/cp.py, the same three functions).

The library is the repository's C++ (native/cutpursuit/cutpursuit.cpp and
maxflow.h), compiled here with g++ and native/Makefile's flags into
<repo>/build/native/libssdrcp_<hash>.so (build/ is listed in .gitignore),
keyed on a hash of the sources and flags, at the first call that needs
it. Nothing is written into native/ and make is not needed; the same
flags keep the partitions equal to those of the library native/Makefile
builds for the JAX package (other flags could contract other FMAs).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCES = [ROOT / "native" / "cutpursuit" / "cutpursuit.cpp",
           ROOT / "native" / "cutpursuit" / "maxflow.h"]
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS and link flag
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-march=native",
             "-shared"]

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile the library if the cached build is missing; return it."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libssdrcp_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the cut-pursuit library needs a "
                           "C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCES[0])],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.cutpursuit_l0.restype = ctypes.c_int
        lib.cutpursuit_l0.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_float), ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.connected_components.restype = ctypes.c_int
        lib.connected_components.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.grid_subsample.restype = ctypes.c_int
        lib.grid_subsample.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def cutpursuit(obs, source, target, edge_weight, reg_strength,
               max_ite: int = 10) -> Tuple[List[np.ndarray], np.ndarray]:
    """L0 minimal partition. Returns (components, in_component) with the
    reference's types: a ragged list of point-index arrays and the int32
    [N] map."""
    obs = np.ascontiguousarray(obs, np.float32)
    source = np.ascontiguousarray(source, np.uint32)
    target = np.ascontiguousarray(target, np.uint32)
    edge_weight = np.ascontiguousarray(edge_weight, np.float32)
    n_ver, dim = obs.shape
    if not len(source) == len(target) == len(edge_weight):
        raise ValueError("cutpursuit: source, target and edge_weight differ "
                         "in length")
    if len(source) and max(source.max(), target.max()) >= n_ver:
        raise ValueError("cutpursuit: an edge names a vertex past n_ver")
    in_component = np.empty(n_ver, np.int32)
    lib = _load()
    n_comp = lib.cutpursuit_l0(
        n_ver, len(source), dim,
        _ptr(obs, ctypes.c_float),
        _ptr(source, ctypes.c_uint32), _ptr(target, ctypes.c_uint32),
        _ptr(edge_weight, ctypes.c_float),
        ctypes.c_float(float(reg_strength)), int(max_ite),
        _ptr(in_component, ctypes.c_int32),
    )
    order = np.argsort(in_component, kind="stable")
    bounds = np.searchsorted(in_component[order], np.arange(n_comp + 1))
    components = [order[bounds[c]: bounds[c + 1]] for c in range(n_comp)]
    return components, in_component


def connected_components(n_ver, source, target, labels) -> np.ndarray:
    """Label-respecting connected components (libply_c.connected_comp,
    reference ply_c.cpp:466-480)."""
    source = np.ascontiguousarray(source, np.uint32)
    target = np.ascontiguousarray(target, np.uint32)
    labels = np.ascontiguousarray(labels, np.int32)
    if len(source) != len(target) or len(labels) != n_ver:
        raise ValueError("connected_components: bad lengths")
    if len(source) and max(source.max(), target.max()) >= n_ver:
        raise ValueError("connected_components: an edge names a vertex "
                         "past n_ver")
    out = np.empty(n_ver, np.int32)
    lib = _load()
    lib.connected_components(
        int(n_ver), len(source),
        _ptr(source, ctypes.c_uint32), _ptr(target, ctypes.c_uint32),
        _ptr(labels, ctypes.c_int32), _ptr(out, ctypes.c_int32),
    )
    return out


def grid_subsample_native(points, features=None, labels=None,
                          grid_size=0.1):
    """Voxel-grid subsampling in the library's C++ (the semantics of
    ops.grid_subsample.grid_subsample_np; the reference's cpp_subsampling
    path)."""
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    fdim = 0
    feat_ptr = ctypes.POINTER(ctypes.c_float)()
    out_feat_ptr = ctypes.POINTER(ctypes.c_float)()
    out_features = None
    if features is not None:
        features = np.ascontiguousarray(features, np.float32)
        fdim = features.shape[1]
        out_features = np.empty((n, fdim), np.float32)
        feat_ptr = _ptr(features, ctypes.c_float)
        out_feat_ptr = _ptr(out_features, ctypes.c_float)
    lab_ptr = ctypes.POINTER(ctypes.c_int32)()
    out_lab_ptr = ctypes.POINTER(ctypes.c_int32)()
    out_labels = None
    num_classes = 0
    if labels is not None:
        labels = np.ascontiguousarray(labels, np.int32).ravel()
        num_classes = int(labels.max()) + 1
        out_labels = np.empty(n, np.int32)
        lab_ptr = _ptr(labels, ctypes.c_int32)
        out_lab_ptr = _ptr(out_labels, ctypes.c_int32)
    out_points = np.empty((n, 3), np.float32)
    lib = _load()
    s = lib.grid_subsample(
        n, fdim, _ptr(points, ctypes.c_float), feat_ptr, lab_ptr,
        num_classes, ctypes.c_float(float(grid_size)),
        _ptr(out_points, ctypes.c_float), out_feat_ptr, out_lab_ptr,
    )
    out = [out_points[:s]]
    if features is not None:
        out.append(out_features[:s])
    if labels is not None:
        out.append(out_labels[:s])
    return out[0] if len(out) == 1 else tuple(out)
