"""AL samplers (counterpart of ssdr_al_tpu/active/samplers.py):
SeedSampler, AllSampler, RandomSampler and TSampler with every diversity
branch ("", edcd, gcn, gcn_fps).

One chunked forward over every training cloud gives per-point classes,
uncertainties and penultimate features on the device; superpoint scores
are segment reductions on the device; the chamfer of the edcd branch and
of the region graph runs in kernel K3, and FPS, the GCN fits and k-center
on the device; the click-budget bookkeeping and the oracle stay on the
host. The random draws use numpy RandomStates in the same order as the
JAX sampler, so both pick from the same seeds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ssdr_al_torch.active.fps_gcn import gcn_fps_sampling
from ssdr_al_torch.active.gcn import gcn_sampling
from ssdr_al_torch.active.oracle import (
    dominant_point_ids_flat,
    gt_dominant_all,
    oracle_labeling,
    seed_labeling,
)
from ssdr_al_torch.active.region_graph import (
    RegionTable,
    SuperpointBlockCache,
    build_region_graph,
    pad_regions_vectorized,
)
from ssdr_al_torch.active.state import ALState, RoundStats
from ssdr_al_torch.active.uncertainty import (
    _class_frequency_weights,
    add_classbal,
    add_clsbal,
    point_uncertainty,
    region_uncertainty,
)
from ssdr_al_torch.config import Config
from ssdr_al_torch.data.cloud import Cloud
from ssdr_al_torch.data.dataset import SamplingPipeline
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.ops.chamfer import chamfer_pairwise
from ssdr_al_torch.ops.fps import farthest_superpoint_sample
from ssdr_al_torch.ops.segment import segment_majority

F16_MAX = 6.5e4   # penult is clipped to ±F16_MAX before its f16 cast


def spread_budget_over_clouds(rng, total_num, number, cloud_names):
    """Multinomial spread of `number` picks over clouds by index-mod
    hashing (sampler2.py:354-366)."""
    rand_inds = rng.choice(range(total_num), int(number), replace=False)
    each = np.zeros(len(cloud_names), np.int64)
    for ind in rand_inds:
        each[ind % len(cloud_names)] += 1
    return each


def _scatter_map(order, j, idx, valid):
    """(source output rows, target point ids) of chunk row j. With sorted
    outputs, output row r holds input row order[r]; rows with
    order[r] < valid scatter to idx[order[r]]."""
    if order is None:
        return slice(0, int(valid)), idx[:valid]
    oj = order[j]
    src = np.flatnonzero(oj < valid)
    return src, idx[oj[src]]


@dataclasses.dataclass
class CloudInference:
    """Per-cloud outputs of the selection-time forward pass."""

    prob_class: np.ndarray            # [N] int32 argmax class
    uncertainty: np.ndarray           # [N] float32 (f16-rounded values)
    penult: np.ndarray | None         # [N, 32] float16, or None when kept
                                      # on the device


class InferenceRunner:
    """Chunked whole-cloud inference (sampler2.py:580-642 + 313-342 in one
    pass). Chunks of every cloud are stacked `chunk_batch` at a time into
    one forward; all groups are launched before any result is read back.

    keep_penult_on_device keeps the f16 penultimate features on the device
    and `region_feature_means` reduces them there."""

    def __init__(self, cfg: Config, clouds: List[Cloud], eval_step, state,
                 point_unc_mode: str, seed: int = 0, chunk_batch: int = 0,
                 keep_penult_on_device: bool = False, *,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.cfg = cfg
        self.eval_step = eval_step
        self.state = state
        self.mode = point_unc_mode
        self.device = resolve_device(device)
        self.keep_penult = keep_penult_on_device
        self._penult_groups: List[torch.Tensor] = []
        self._row_map: Dict[str, np.ndarray] = {}
        self.chunk_batch = chunk_batch or min(
            32, max(8, 327_680 // cfg.num_points))
        self.pipe = SamplingPipeline(clouds, cfg, seed=seed)

    def _reduced(self, batch):
        """Forward + the per-point reductions, all on the device."""
        res = self.eval_step(self.state, batch)
        probs, feats = res[0], res[1]
        with torch.inference_mode():
            unc = point_uncertainty(probs, self.mode).half()
            cls = torch.argmax(probs, dim=-1).to(torch.uint8)
            f16 = torch.clamp(feats.float(), -F16_MAX, F16_MAX).half()
        order = res[2] if len(res) == 3 else None
        return cls, unc, f16, order

    def run_many(self, clouds: List[Cloud]) -> Dict[str, CloudInference]:
        """Whole-dataset inference with chunk groups spanning cloud
        boundaries. The scatter back to cloud order runs on the host with
        numpy's last-assignment-wins rule: padded chunk rows repeat points,
        and a device scatter with duplicate targets has no defined winner."""
        cb = max(self.chunk_batch, 1)
        flat = []
        for cloud in clouds:
            for chunk in self.pipe.cloud_chunks(cloud):
                flat.append((cloud.name, chunk))
        groups = [flat[i: i + cb] for i in range(0, len(flat), cb)]
        if groups and len(groups[-1]) < cb:
            pad = groups[-1][-1][1]   # repeat a chunk; results discarded
            groups[-1] = groups[-1] + [(None, pad)] * (cb - len(groups[-1]))
        pending = []
        for g in groups:
            batch = {k: np.concatenate([c[0][k] for _, c in g], axis=0)
                     for k in g[0][1][0]}
            cls, u, f16, order = self._reduced(batch)
            if self.keep_penult:
                self._penult_groups.append(f16)
                f16 = None
            pending.append((g, cls, u, f16, order))
        out = {
            c.name: CloudInference(
                np.zeros(c.num_points, np.int32),
                np.zeros(c.num_points, np.float32),
                None if self.keep_penult
                else np.zeros((c.num_points, 32), np.float16),
            )
            for c in clouds
        }
        if self.keep_penult:
            self._row_map = {c.name: np.full(c.num_points, -1, np.int64)
                             for c in clouds}
        n = self.cfg.num_points
        for gi, (g, cls, u, feats, order) in enumerate(pending):
            cls, u = cls.cpu().numpy(), u.cpu().numpy()
            feats = None if feats is None else feats.cpu().numpy()
            order = None if order is None else order.cpu().numpy()
            for j, (name, (_, idx, valid)) in enumerate(g):
                if name is None:
                    continue
                o = out[name]
                src, tgt = _scatter_map(order, j, idx, valid)
                o.prob_class[tgt] = cls[j][src]
                o.uncertainty[tgt] = u[j][src]
                if feats is not None:
                    o.penult[tgt] = feats[j][src]
                if self.keep_penult:
                    rows = np.arange(valid) if order is None else src
                    self._row_map[name][tgt] = (gi * cb + j) * n + rows
        return out

    def region_feature_means(self, slot_of_point: Dict[str, np.ndarray],
                             num_slots: int) -> np.ndarray:
        """[num_slots, 32] f32 mean retained penult feature per region slot.
        slot_of_point: per-cloud [num_points] slot id or −1. The sums run on
        the device in float64 (index_add_ on CUDA adds in no fixed order;
        f64 sums of f16 values make that order immaterial at f32 output)."""
        if not self._penult_groups:
            raise RuntimeError("run_many(keep_penult_on_device) not run")
        rows = sum(int(g.shape[0]) * int(g.shape[1])
                   for g in self._penult_groups)
        slot = np.full(rows, num_slots, np.int64)        # trash slot
        for name, sp in slot_of_point.items():
            rm = self._row_map[name]
            pts = np.flatnonzero((sp >= 0) & (rm >= 0))
            slot[rm[pts]] = sp[pts]
        slot_t = torch.from_numpy(slot).to(self.device)
        d = self._penult_groups[0].shape[-1]
        sums = torch.zeros((num_slots + 1, d), dtype=torch.float64,
                           device=self.device)
        cnt = torch.zeros(num_slots + 1, dtype=torch.float64,
                          device=self.device)
        off = 0
        for g in self._penult_groups:
            r = g.shape[0] * g.shape[1]
            s = slot_t[off:off + r]
            sums.index_add_(0, s, g.reshape(r, d).double())
            cnt.index_add_(0, s, torch.ones(r, dtype=torch.float64,
                                            device=self.device))
            off += r
        means = sums[:num_slots] / cnt[:num_slots].clamp(min=1.0)[:, None]
        return means.float().cpu().numpy()


class SeedSampler:
    """Random precise labeling of whole superpoints (sampler2.py:344-408)."""

    def __init__(self, state: ALState, clouds: List[Cloud], total_num: int,
                 seed: int = 0):
        self.state = state
        self.clouds = {c.name: c for c in clouds}
        self.total_num = total_num
        self.rng = np.random.RandomState(seed)

    def sampling(self, batch_size: int, last_round: int, stats: RoundStats):
        round_dir = self.state.begin_round(last_round,
                                           seed_from_superpoint=True)
        total_obj = self.state.load_registry(round_dir)
        self._iteration(round_dir, total_obj, batch_size, stats)

    def _iteration(self, round_dir, total_obj, number, stats):
        remain = 0
        cloud_names = list(total_obj["unlabeled"])
        each = spread_budget_over_clouds(self.rng, self.total_num, number,
                                         cloud_names)
        for i, name in enumerate(cloud_names):
            if each[i] == 0:
                continue
            unl = total_obj["unlabeled"][name]
            if len(unl) >= each[i]:
                sp_inds = self.rng.choice(list(unl), int(each[i]),
                                          replace=False)
            else:
                sp_inds = list(unl)
                remain += each[i] - len(sp_inds)
            sp = self.state.load_superpoints(name)
            pseudo_gt = self.state.load_pseudo_gt(round_dir, name)
            seed_labeling(sp_inds, sp.components, self.clouds[name].labels,
                          pseudo_gt, stats)
            self.state.write_pseudo_gt(round_dir, name, pseudo_gt)
            self.state.mark_labeled(total_obj, name, sp_inds)
        if remain == 0 or not total_obj["unlabeled"]:
            self.state.write_registry(total_obj, round_dir)
        else:
            self._iteration(round_dir, total_obj, remain, stats)


class AllSampler:
    """Label every superpoint with the oracle (baseline / max-dominant,
    sampler2.py:410-453)."""

    def __init__(self, state: ALState, clouds: List[Cloud], total_num: int,
                 oracle_mode: str = "dominant"):
        self.state = state
        self.clouds = {c.name: c for c in clouds}
        self.total_num = total_num
        self.oracle_mode = oracle_mode

    def sampling(self, batch_size: int, last_round: int, stats: RoundStats,
                 threshold: float = 0.9):
        budget = {"click": batch_size}
        round_dir = self.state.begin_round(
            last_round, seed_from_superpoint=(last_round == 1))
        total_obj = self.state.load_registry(round_dir)
        for name in list(total_obj["unlabeled"]):
            sp = self.state.load_superpoints(name)
            pseudo_gt = self.state.load_pseudo_gt(round_dir, name)
            pseudo_gt, used = oracle_labeling(
                list(total_obj["unlabeled"][name]), sp.components,
                self.clouds[name].labels, pseudo_gt, stats, self.oracle_mode,
                None, threshold, budget, 1,
                total_obj["selected_class_list"])
            self.state.write_pseudo_gt(round_dir, name, pseudo_gt)
            self.state.mark_labeled(total_obj, name, used)
        self.state.write_registry(total_obj, round_dir)


class RandomSampler:
    """Random superpoints labelled by the oracle (sampler2.py:455-520)."""

    def __init__(self, state: ALState, clouds: List[Cloud], total_num: int,
                 min_size: int, oracle_mode: str = "dominant", seed: int = 0):
        self.state = state
        self.clouds = {c.name: c for c in clouds}
        self.total_num = total_num
        self.min_size = min_size
        self.oracle_mode = oracle_mode
        self.rng = np.random.RandomState(seed)

    def sampling(self, batch_size: int, last_round: int, stats: RoundStats,
                 threshold: float = 0.9):
        budget = {"click": batch_size}
        round_dir = self.state.begin_round(last_round, from_seed_round=True)
        total_obj = self.state.load_registry(round_dir)
        self._iteration(round_dir, total_obj, stats, threshold, budget)

    def _iteration(self, round_dir, total_obj, stats, threshold, budget):
        cloud_names = list(total_obj["unlabeled"])
        each = spread_budget_over_clouds(self.rng, self.total_num,
                                         budget["click"], cloud_names)
        for i, name in enumerate(cloud_names):
            if each[i] == 0:
                continue
            unl = list(total_obj["unlabeled"][name])
            if len(unl) >= each[i]:
                sp_inds = self.rng.choice(unl, int(each[i]), replace=False)
            else:
                sp_inds = unl
            sp = self.state.load_superpoints(name)
            pseudo_gt = self.state.load_pseudo_gt(round_dir, name)
            pseudo_gt, used = oracle_labeling(
                sp_inds, sp.components, self.clouds[name].labels, pseudo_gt,
                stats, self.oracle_mode, None, threshold, budget,
                self.min_size, total_obj["selected_class_list"])
            self.state.write_pseudo_gt(round_dir, name, pseudo_gt)
            self.state.mark_labeled(total_obj, name, used)
        if budget["click"] == 0 or not total_obj["unlabeled"]:
            self.state.write_registry(total_obj, round_dir)
        else:
            self._iteration(round_dir, total_obj, stats, threshold, budget)


@dataclasses.dataclass
class TSamplerArgs:
    point_uncertainty_mode: str = "sb"       # lc | entropy | sb
    uncertainty_mode: str = "WetSU"          # mean | sum_weight | WetSU
    oracle_mode: str = "NAIL"                # dominant | NAIL
    class_balance: str = "clsbal"            # "" | classbal | clsbal
    diversity: str = "gcn_fps"               # "" | edcd | gcn | gcn_fps
    threshold: float = 0.9
    min_size: int = 1
    gcn_number: int = 1
    gcn_top: int = 0
    # cap on the points per superpoint in the chamfer (linspace subsample);
    # 0 = no cap
    chamfer_cap: int = 512
    # JAX's bf16x3 chamfer switch; every setting runs the exact K3 here
    # (region_graph.py)
    chamfer_mxu: Optional[bool] = None


class TSampler:
    """Uncertainty + diversity selection (sampler2.py:522-810)."""

    def __init__(self, state: ALState, clouds: List[Cloud], cfg: Config,
                 args: TSamplerArgs, total_num: int, seed: int = 0, *,
                 device: torch.device | str = DEFAULT_DEVICE):
        if args.diversity not in ("", "edcd", "gcn", "gcn_fps"):
            raise ValueError(f"unknown diversity {args.diversity!r}")
        self.state = state
        self.clouds = clouds
        self.cloud_by_name = {c.name: c for c in clouds}
        self.cfg = cfg
        self.args = args
        self.total_num = total_num
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(seed)
        self._gt_dom_cache: Dict[str, tuple] = {}
        self._runner = None        # round-lifetime InferenceRunner
        self._block_cache = None   # run-lifetime superpoint slab
        self.phase_times: Dict[str, float] = {}

    # -------------------------------------------------------- prediction ---
    def prediction(self, eval_step, model_state, total_obj, round_num,
                   stats: RoundStats):
        """One inference pass over all training clouds → scored unlabeled
        regions + labeled-region registry (sampler2.py:580-642)."""
        a = self.args
        runner = InferenceRunner(
            self.cfg, self.clouds, eval_step, model_state,
            a.point_uncertainty_mode, seed=self.rng.randint(1 << 31),
            keep_penult_on_device=(a.diversity in ("gcn", "gcn_fps")),
            device=self.device,
        )
        self._runner = runner
        inference = runner.run_many(list(self.clouds))

        seg_in, unc_in, cls_in, per_cloud = [], [], [], []
        s_off = 0
        for cloud in self.clouds:
            sp = self.state.load_superpoints(cloud.name)
            s = sp.num_superpoints
            inf = inference[cloud.name]
            seg_in.append(sp.in_component.astype(np.int64) + s_off)
            unc_in.append(inf.uncertainty)
            cls_in.append(inf.prob_class)
            per_cloud.append((cloud.name, sp, s, s_off))
            s_off += s
        runc_all, dom_all = self._score_flat(
            np.concatenate(unc_in), np.concatenate(cls_in),
            np.concatenate(seg_in), s_off, a.uncertainty_mode)

        unc_parts: List[np.ndarray] = []
        cls_parts: List[np.ndarray] = []
        labeled_by_cloud: Dict[str, np.ndarray] = {}
        cloud_names: List[str] = []
        t_cloud, t_sp, t_arena, t_counts = [], [], [], []
        for name, sp, s, off in per_cloud:
            ci = len(cloud_names)
            cloud_names.append(name)
            runc = runc_all[off: off + s]
            dom = dom_all[off: off + s]
            ids_flat, counts = dominant_point_ids_flat(
                sp.in_component, s, inference[name].prob_class, dom)
            keep = sp.sizes >= a.min_size
            unl_mask = np.zeros(s, bool)
            unl_list = np.asarray(
                list(total_obj["unlabeled"].get(name, [])), np.int64)
            if unl_list.size:
                unl_mask[unl_list] = True
            unl_keep = np.flatnonzero(keep & unl_mask)
            lab_keep = np.flatnonzero(keep & ~unl_mask)
            unc_parts.append(runc[unl_keep])
            cls_parts.append(dom[unl_keep])
            keep_mask = np.zeros(s, bool)
            keep_mask[unl_keep] = True
            seg_of_id = np.repeat(np.arange(s, dtype=np.int64), counts)
            t_arena.append(ids_flat[keep_mask[seg_of_id]])
            t_counts.append(counts[unl_keep])
            t_cloud.append(np.full(len(unl_keep), ci, np.int32))
            t_sp.append(unl_keep.astype(np.int64))
            if lab_keep.size:
                labeled_by_cloud[name] = lab_keep.astype(np.int64)

        def cat(parts, dtype):
            return np.concatenate(parts) if parts else np.zeros(0, dtype)

        counts_all = cat(t_counts, np.int64)
        offsets = np.zeros(len(counts_all) + 1, np.int64)
        np.cumsum(counts_all, out=offsets[1:])
        table = RegionTable(
            cloud_names, cat(t_cloud, np.int32), cat(t_sp, np.int64),
            np.zeros(len(counts_all), bool), cat(t_arena, np.int64), offsets)
        region_unc = cat(unc_parts, np.float32)
        region_class = cat(cls_parts, np.int64).astype(np.int64)
        if a.class_balance == "classbal":
            region_unc = add_classbal(self.cfg.num_classes, region_class,
                                      region_unc)
        elif a.class_balance == "clsbal":
            region_unc = add_clsbal(self.cfg.num_classes, region_class,
                                    region_unc,
                                    total_obj["selected_class_list"])
        sorted_inds = np.argsort(-region_unc)
        return table, sorted_inds, inference, labeled_by_cloud

    def _score_flat(self, unc_in, cls_in, seg_in, total_s: int, mode: str):
        """Region uncertainty + dominant predicted class of every superpoint
        of every cloud, in one device pass."""
        dev = self.device
        unc = torch.from_numpy(np.ascontiguousarray(unc_in, np.float32)).to(dev)
        cls = torch.from_numpy(np.ascontiguousarray(cls_in, np.int64)).to(dev)
        seg = torch.from_numpy(np.ascontiguousarray(seg_in, np.int64)).to(dev)
        runc = region_uncertainty(unc, cls, seg, total_s,
                                  self.cfg.num_classes, mode)
        dom, _ = segment_majority(cls, seg, total_s, self.cfg.num_classes)
        return runc.cpu().numpy(), dom.cpu().numpy()

    # ------------------------------------------------------------ anchors ---
    def _gt_dominant(self, name):
        """(GT dominant label [S], dominant-id arena, offsets [S+1]) of a
        cloud, cached: ground truth never changes."""
        hit = self._gt_dom_cache.get(name)
        if hit is None:
            sp = self.state.load_superpoints(name)
            labels = self.cloud_by_name[name].labels
            s = sp.num_superpoints
            dom = gt_dominant_all(sp.in_component, s, labels,
                                  self.cfg.num_classes)
            ids, counts = dominant_point_ids_flat(sp.in_component, s, labels,
                                                  dom)
            offsets = np.zeros(s + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            hit = (dom, ids, offsets)
            self._gt_dom_cache[name] = hit
        return hit

    def select_labeled_anchors(self, labeled_by_cloud, round_num) -> RegionTable:
        """Class-weighted random sample of labeled superpoints, capped at
        (round_num−1)·1000 (sampler2.py:268-311)."""
        names = list(labeled_by_cloud)
        c_parts, s_parts, d_parts = [], [], []
        for ci, name in enumerate(names):
            dom, _, _ = self._gt_dominant(name)
            arr = np.asarray(labeled_by_cloud[name], np.int64)
            d_parts.append(dom[arr])
            s_parts.append(arr)
            c_parts.append(np.full(len(arr), ci, np.int32))
        if not s_parts or sum(len(x) for x in s_parts) == 0:
            return RegionTable.empty()
        dominant_labels = np.concatenate(d_parts)
        w = _class_frequency_weights(dominant_labels, self.cfg.num_classes)
        p = w / w.sum()
        total = len(dominant_labels)
        batch = min((round_num - 1) * 1000, total)
        sel = self.rng.choice(total, batch, replace=False, p=p)
        cloud_ids = np.concatenate(c_parts)[sel]
        sp_sel = np.concatenate(s_parts)[sel]
        id_parts, base, pos = [], {}, 0
        for ci, name in enumerate(names):
            _, ids_c, _ = self._gt_dominant(name)
            id_parts.append(ids_c)
            base[ci] = pos
            pos += len(ids_c)
        global_ids = np.concatenate(id_parts)
        starts = np.zeros(batch, np.int64)
        ends = np.zeros(batch, np.int64)
        for ci, name in enumerate(names):
            m = cloud_ids == ci
            if not m.any():
                continue
            _, _, offs_c = self._gt_dominant(name)
            sps = sp_sel[m]
            starts[m] = offs_c[sps] + base[ci]
            ends[m] = offs_c[sps + 1] + base[ci]
        counts = ends - starts
        offsets = np.zeros(batch + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        rep = np.repeat(np.arange(batch), counts)
        within = np.arange(int(offsets[-1])) - np.repeat(offsets[:-1], counts)
        arena = global_ids[starts[rep] + within]
        return RegionTable(names, cloud_ids, sp_sel, np.ones(batch, bool),
                           arena, offsets)

    # ----------------------------------------------------------- sampling ---
    def sampling(self, eval_step, model_state, batch_size, last_round,
                 stats: RoundStats):
        """One selection round: label up to batch_size clicks and write
        round_<last_round+1>/ (.gt files and total.pkl)."""
        a = self.args
        budget = {"click": batch_size}
        round_dir = self.state.begin_round(last_round, from_seed_round=True)
        total_obj = self.state.load_registry(round_dir)
        round_num = last_round + 1

        t0 = time.perf_counter()
        table, sorted_inds, inference, labeled_by_cloud = self.prediction(
            eval_step, model_state, total_obj, round_num, stats)
        self.phase_times = {"prediction_s": time.perf_counter() - t0}
        # the candidate count is capped by the scored regions, the click
        # budget keeps its value (sampler2.py:645-646, 671-672)
        batch_size = min(batch_size, len(table))

        t0 = time.perf_counter()
        if a.diversity == "edcd":
            file_list = self._edcd_selection(table, sorted_inds, batch_size,
                                             stats)
        elif a.diversity in ("gcn", "gcn_fps"):
            file_list = self._graph_selection(
                table, sorted_inds, labeled_by_cloud, batch_size, round_num,
                stats)
        else:
            file_list = {}
            for i in sorted_inds[:batch_size]:
                file_list.setdefault(table.cloud_name(i), []).append(
                    int(table.sp_idx[i]))
        self.phase_times["diversity_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self._record_selection_stats(file_list, total_obj, stats)
        for name, sp_inds in file_list.items():
            sp = self.state.load_superpoints(name)
            pseudo_gt = self.state.load_pseudo_gt(round_dir, name)
            pseudo_gt, used = oracle_labeling(
                sp_inds, sp.components, self.cloud_by_name[name].labels,
                pseudo_gt, stats, a.oracle_mode,
                inference[name].prob_class, a.threshold, budget, a.min_size,
                total_obj["selected_class_list"])
            self.state.write_pseudo_gt(round_dir, name, pseudo_gt)
            self.state.mark_labeled(total_obj, name, used)
        self.state.write_registry(total_obj, round_dir)
        self.phase_times["oracle_s"] = time.perf_counter() - t0
        self._runner = None  # free the retained device penult buffers

    def _top_candidates(self, table: RegionTable, sorted_inds, batch_size):
        """(top_counts {name: count}, candidates {name: rank-ordered table
        rows}): the B best and per-cloud 2·B candidate pools
        (sampler2.py:533-552, 697-705). Dict order = first appearance in
        the ranked list, which orders the oracle's budget use."""
        c = len(table.cloud_names)
        top_rows = sorted_inds[:batch_size]
        tc = np.bincount(table.cloud_ids[top_rows], minlength=c)
        cloud_of_sorted = table.cloud_ids[sorted_inds]
        order = np.argsort(cloud_of_sorted, kind="stable")
        grouped = sorted_inds[order]
        counts_all = np.bincount(cloud_of_sorted, minlength=c)
        starts = np.zeros(c + 1, np.int64)
        np.cumsum(counts_all, out=starts[1:])
        cids, first = np.unique(table.cloud_ids[top_rows], return_index=True)
        top_counts: Dict[str, int] = {}
        candidates: Dict[str, np.ndarray] = {}
        for ci in cids[np.argsort(first)]:
            name = table.cloud_names[ci]
            top_counts[name] = int(tc[ci])
            lim = min(2 * int(tc[ci]), int(counts_all[ci]))
            candidates[name] = grouped[starts[ci]: starts[ci] + lim]
        return top_counts, candidates

    def _edcd_selection(self, table, sorted_inds, batch_size, stats):
        """Per-cloud FPS over ED² + chamfer (sampler2.py:670-685, 554-578):
        each candidate cloud's 2·B pool padded on the host, its chamfer in
        K3 and its FPS on the device."""
        top_counts, candidates = self._top_candidates(table, sorted_inds,
                                                      batch_size)
        stats.extra["before_gcn_file_num"] = len(top_counts)
        file_list: Dict[str, List[int]] = {}
        for name, rows in candidates.items():
            sp_ids = table.sp_idx[rows]
            sp = self.state.load_superpoints(name)
            cents, pts, msk = pad_regions_vectorized(
                self.cloud_by_name[name].xyz,
                [sp.components[s] for s in sp_ids],
                self.args.chamfer_cap or None)
            cd = chamfer_pairwise(torch.from_numpy(pts).to(self.device),
                                  torch.from_numpy(msk).to(self.device))
            sel = farthest_superpoint_sample(
                torch.from_numpy(cents).to(self.device), cd, 0,
                top_counts[name]).cpu().numpy()
            file_list[name] = [int(sp_ids[i]) for i in sel]
        return file_list

    def _graph_selection(self, table, sorted_inds, labeled_by_cloud,
                         batch_size, round_num, stats):
        """gcn / gcn_fps branches (sampler2.py:687-781)."""
        a = self.args
        t0 = time.perf_counter()
        top_counts, candidates = self._top_candidates(table, sorted_inds,
                                                      batch_size)
        stats.extra["before_gcn_file_num"] = len(top_counts)
        anchors = self.select_labeled_anchors(labeled_by_cloud, round_num)
        sampling_batch = sum(top_counts.values())
        self.phase_times["div_cand_anchor_s"] = time.perf_counter() - t0
        if sampling_batch == 0:
            return {}
        t0 = time.perf_counter()
        regions_by_cloud: Dict[str, list] = {}
        for name, rows in candidates.items():
            regs = regions_by_cloud.setdefault(name, [])
            for r in rows:
                regs.append((int(table.sp_idx[r]), False, table.dom_ids(r)))
        for r in range(len(anchors)):
            regions_by_cloud.setdefault(anchors.cloud_name(r), []).append(
                (int(anchors.sp_idx[r]), True, anchors.dom_ids(r)))
        if self._block_cache is None:
            # stage EVERY training cloud once: superpoints are fixed for
            # the run, later rounds only gather slab rows
            self._block_cache = SuperpointBlockCache(
                a.chamfer_cap or None, device=self.device,
                mxu=a.chamfer_mxu)
            for c in self.clouds:
                self._block_cache.ensure(
                    c.name, c.xyz,
                    self.state.load_superpoints(c.name).components)
        self._block_cache.finalize()
        graph = build_region_graph(regions_by_cloud,
                                   cache=self._block_cache)
        for k, v in graph.timings.items():
            self.phase_times[f"div_graph_{k}"] = v
        self.phase_times["div_graph_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # region features: mean penultimate feature over the dominant point
        # ids (compute_features, sampler2.py:313-342), reduced on the device
        unlabeled_flags = np.zeros(graph.num_regions, bool)
        by_cloud: Dict[str, List[int]] = {}
        for i, ref in enumerate(graph.refs):
            unlabeled_flags[i] = not ref.is_labeled
            by_cloud.setdefault(ref.cloud_name, []).append(i)
        slot_maps: Dict[str, np.ndarray] = {}
        for name, idxs in by_cloud.items():
            sm = np.full(self.cloud_by_name[name].num_points, -1, np.int64)
            ids = [graph.refs[i].dominant_point_ids for i in idxs]
            lens = np.fromiter((len(x) for x in ids), np.int64,
                               count=len(ids))
            sm[np.concatenate(ids)] = np.repeat(np.asarray(idxs, np.int64),
                                                lens)
            slot_maps[name] = sm
        feats = self._runner.region_feature_means(slot_maps,
                                                  graph.num_regions)
        self.phase_times["div_feats_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            if a.diversity == "gcn_fps":
                return gcn_fps_sampling(
                    graph, feats, unlabeled_flags, sampling_batch,
                    gcn_number=a.gcn_number, gcn_top=a.gcn_top, rng=self.rng,
                    device=self.device)
            return gcn_sampling(graph, feats, unlabeled_flags,
                                sampling_batch,
                                seed=int(self.rng.randint(1 << 31)),
                                device=self.device)
        finally:
            self.phase_times["div_gcn_s"] = time.perf_counter() - t0

    def _record_selection_stats(self, file_list, total_obj, stats):
        """gcn_file_num / gcn_sp_num / gcn_unlabel_num (sampler2.py:765-772)."""
        stats.extra["gcn_file_num"] = len(file_list)
        stats.extra["gcn_sp_num"] = sum(len(v) for v in file_list.values())
        n_unl = 0
        for name, sps in file_list.items():
            unl = total_obj["unlabeled"].get(name, ())
            n_unl += sum(1 for s in sps if s in unl)
        stats.extra["gcn_unlabel_num"] = n_unl
