"""Active-learning state store: superpoints, pseudo-GT, round directories.

A numpy copy of ssdr_al_tpu/active/state.py, byte-compatible with its
on-disk round protocol: importing it from the JAX package would import
jax (ssdr_al_tpu/active/__init__.py pulls in active/uncertainty.py).

The reference keeps AL state on disk as pickles and copies a directory per
round (sampler2.py:194-216, 388-408, 653-667):

  data/<ds>/<reg>/superpoint/<cloud>.superpoint   {components, in_component}
  data/<ds>/<reg>/superpoint/<cloud>.gt           float32 [2, N]
                                                   row 0 activation, row 1 pseudo-label
  data/<ds>/<reg>/superpoint/total.pkl            registry {unlabeled, file_num,
                                                   sp_num, point_num, selected_class_list}
  data/<ds>/<reg>/sampling/<args>/round_<r>/      per-round copies of .gt + total.pkl

This module keeps the SAME on-disk semantics (so runs are resumable per round
and artifacts are inspectable/comparable with the reference), wrapped in an
explicit `ALState` object. Superpoints are ADDITIONALLY stored as a dense
`in_component` int32 array per cloud — the TPU-friendly representation used
for segment reductions (SURVEY.md §7 hard-parts: ragged → segment-id maps).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
from typing import Dict, List, Optional

import numpy as np


def sampler_args_str(sampler_args) -> str:
    """Experiment-ID string; parity with base_op.get_sampler_args_str:3-10."""
    return "-".join(str(a) for a in sampler_args)


@dataclasses.dataclass
class RoundStats:
    """Labeling statistics dict `w` (ssdr_main_S3DIS2.py:141, base_op.py:12-16)."""

    sp_num: int = 0          # whole superpoints labeled
    p_num: int = 0           # points labeled via whole superpoints
    sub_num: int = 0         # sub-regions labeled (NAIL split)
    sub_p_num: int = 0       # points labeled via sub-regions
    ignore_sp_num: int = 0   # superpoints paid for but unlabeled (NAIL)
    split_sp_num: int = 0    # superpoints that were split (NAIL)
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)

    def as_dict(self):
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        d.update(extra)
        return d

    def __str__(self):
        return ", ".join(f"{k}={v}" for k, v in self.as_dict().items())


@dataclasses.dataclass
class Superpoints:
    """One cloud's oversegmentation."""

    components: List[np.ndarray]   # ragged: per-superpoint point indices
    in_component: np.ndarray       # [N] int32 segment id per point
    _sizes: Optional[np.ndarray] = None

    @property
    def num_superpoints(self) -> int:
        return len(self.components)

    @property
    def sizes(self) -> np.ndarray:
        """Points per superpoint, [S] int64 (cached)."""
        if self._sizes is None:
            self._sizes = np.bincount(
                self.in_component, minlength=self.num_superpoints
            )
        return self._sizes


class ALState:
    """Filesystem-backed AL state with the reference's directory layout.

    write_files=False keeps every write in memory instead (the pickled
    bytes a file would hold, read back before the disk): the state of a
    data-parallel rank other than 0, which takes the same decisions as
    rank 0 while rank 0 alone writes the files."""

    def __init__(self, data_path: str, sampler_args=(), *,
                 write_files: bool = True):
        self.data_path = data_path           # data/<ds>/<reg_strength>
        self.sampler_args = list(sampler_args)
        self.superpoint_dir = os.path.join(data_path, "superpoint")
        self._sp_cache: Dict[str, Superpoints] = {}
        self._held: Optional[Dict[str, bytes]] = \
            None if write_files else {}

    # ------------------------------------------------------------- files ---
    def _dump(self, path: str, obj):
        if self._held is not None:
            self._held[os.path.normpath(path)] = pickle.dumps(obj)
            return
        with open(path, "wb") as f:
            pickle.dump(obj, f)

    def _load(self, path: str):
        held = None if self._held is None else \
            self._held.get(os.path.normpath(path))
        if held is not None:
            return pickle.loads(held)
        with open(path, "rb") as f:
            return pickle.load(f)

    def _files(self, where: str) -> List[str]:
        """The names of the files in `where`, held ones included."""
        names = {f for f in os.listdir(where)
                 if os.path.isfile(os.path.join(where, f))} \
            if os.path.isdir(where) else set()
        for p in self._held or ():
            if os.path.dirname(p) == os.path.normpath(where):
                names.add(os.path.basename(p))
        return sorted(names)

    # ------------------------------------------------------------ layout ---
    def round_dir(self, round_num: int, sampler_args=None) -> str:
        args = self.sampler_args if sampler_args is None else sampler_args
        return os.path.join(
            self.data_path, "sampling", sampler_args_str(args),
            "round_" + str(round_num),
        )

    # ------------------------------------------------------- superpoints ---
    def write_superpoints(self, cloud_name: str, components, in_component,
                          num_points: int):
        """Persist a partition + a zeroed pseudo-gt, as compute_superpoint.py:63-74."""
        if self._held is None:
            os.makedirs(self.superpoint_dir, exist_ok=True)
        comp_arr = np.empty(len(components), dtype=object)
        for i, c in enumerate(components):
            comp_arr[i] = np.asarray(c, dtype=np.int64)
        sp = {"components": comp_arr,
              "in_component": np.asarray(in_component, dtype=np.int32)}
        self._dump(os.path.join(self.superpoint_dir,
                                cloud_name + ".superpoint"), sp)
        self._dump(os.path.join(self.superpoint_dir, cloud_name + ".gt"),
                   np.zeros([2, num_points], dtype=np.float32))

    def load_superpoints(self, cloud_name: str) -> Superpoints:
        if cloud_name in self._sp_cache:
            return self._sp_cache[cloud_name]
        sp = self._load(os.path.join(self.superpoint_dir,
                                     cloud_name + ".superpoint"))
        components = [np.asarray(c, dtype=np.int64) for c in sp["components"]]
        in_component = np.asarray(sp["in_component"], dtype=np.int32)
        out = Superpoints(components=components, in_component=in_component)
        self._sp_cache[cloud_name] = out
        return out

    # ----------------------------------------------------------- registry ---
    def write_registry(self, total_obj: dict, where: Optional[str] = None):
        where = where or self.superpoint_dir
        self._dump(os.path.join(where, "total.pkl"), total_obj)

    def load_registry(self, where: Optional[str] = None) -> dict:
        where = where or self.superpoint_dir
        total_obj = self._load(os.path.join(where, "total.pkl"))
        # sampler2.py:439-440 — lazily added key
        total_obj.setdefault("selected_class_list", [])
        return total_obj

    # ---------------------------------------------------------- pseudo-gt ---
    def load_pseudo_gt(self, round_dir: str, cloud_name: str) -> np.ndarray:
        return np.asarray(self._load(os.path.join(round_dir,
                                                  cloud_name + ".gt")),
                          dtype=np.float32)

    def write_pseudo_gt(self, round_dir: str, cloud_name: str, pseudo_gt):
        self._dump(os.path.join(round_dir, cloud_name + ".gt"),
                   np.asarray(pseudo_gt, dtype=np.float32))

    # ------------------------------------------------------------- rounds ---
    def begin_round(self, last_round: int, *, seed_from_superpoint=False,
                    from_seed_round=False) -> str:
        """Copy last round's .gt + total.pkl into round_{last_round+1}.

        Mirrors the copy loop in every sampler (sampler2.py:395-402, 648-661):
          - last_round == 0 (or seed_from_superpoint): copy from superpoint/
          - from_seed_round: copy from sampling/seed/round_1 (TSampler:648-650)
        """
        if last_round == 0 or seed_from_superpoint:
            src = self.superpoint_dir
        elif from_seed_round and last_round == 1:
            src = os.path.join(self.data_path, "sampling", "seed", "round_1")
        else:
            src = self.round_dir(last_round)
        dst = self.round_dir(last_round + 1)
        if self._held is not None:
            for fname in self._files(src):
                if ".superpoint" not in fname:
                    self._held[os.path.normpath(os.path.join(dst, fname))] \
                        = pickle.dumps(self._load(os.path.join(src, fname)))
            return dst
        os.makedirs(dst, exist_ok=True)
        for fname in os.listdir(src):
            p = os.path.join(src, fname)
            if os.path.isfile(p) and ".superpoint" not in fname:
                shutil.copyfile(p, os.path.join(dst, fname))
        return dst

    def mark_labeled(self, total_obj: dict, cloud_name: str, used_sp_inds):
        """Shrink the unlabeled set (sampler2.py:214-216)."""
        remaining = set(total_obj["unlabeled"][cloud_name]) - set(int(i) for i in used_sp_inds)
        total_obj["unlabeled"][cloud_name] = list(remaining)
        if not remaining:
            del total_obj["unlabeled"][cloud_name]
