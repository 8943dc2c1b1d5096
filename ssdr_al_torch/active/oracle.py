"""Simulated oracle labeling: dominant-label and NAIL modes.

A numpy copy of ssdr_al_tpu/active/oracle.py, byte-compatible with its
on-disk round protocol: importing it from the JAX package would import
jax (ssdr_al_tpu/active/__init__.py pulls in active/uncertainty.py).

Behavior-parity port of sampler2.py:102-245 (oracle_labeling, _dominant_label,
_get_sub_region_from_superpoint, _help_seed). This is the AL bookkeeping —
sequential budget accounting over at most `sp_batch_size` small regions per
round — so it stays on the host; the expensive per-region statistics it
consumes (uncertainty ordering, predicted classes) are produced on device.

Invariants (tested in tests/test_active.py, incl. the reference-parity
suite in tests/test_reference_parity.py):
  - budget["click"] decrements once per paid interaction (superpoint click,
    or sub-region confirmation in NAIL). The top-of-loop guard only checks
    budget > 0 BEFORE a superpoint is processed, so in NAIL mode the budget
    CAN overshoot past zero inside a single superpoint's sub-region split —
    exactly as the reference does (sampler2.py:167-180 decrements per
    confirmed sub-region with no guard). Overshoot is bounded by one
    superpoint's sub-region count.
  - pseudo-gt activation is monotone non-decreasing
  - a labeled region's pseudo-labels are constant = its dominant GT label
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ssdr_al_torch.active.state import RoundStats


def dominant_label(labels: np.ndarray):
    """(argmax label, dominance rate); sampler2.py:102-106."""
    labels = np.asarray(labels, np.int64)
    hist = np.bincount(labels)
    return int(hist.argmax()), float(hist.max()) / len(labels)


def dominant_point_ids(point_ids: np.ndarray, labels: np.ndarray):
    """Point ids holding the dominant label; sampler2.py:108-115 (_dominant_2)."""
    labels = np.asarray(labels, np.int64)
    hist = np.bincount(labels)
    label = int(hist.argmax())
    point_ids = np.asarray(point_ids)
    return label, point_ids[labels == label]


def dominant_point_ids_all(in_component, num_superpoints, labels, dominant):
    """Vectorized `dominant_point_ids` over ALL superpoints of a cloud.

    Kills the reference's hot per-superpoint scoring loop
    (sampler2.py:612-631): instead of one bincount + boolean mask per
    region, one O(N) pass builds every region's dominant-label point-id
    list at once.

    in_component [N] int32 segment map; labels [N] int (predicted or GT
    classes); dominant [S] the per-superpoint dominant label (from
    ops.segment.segment_majority on device, or a host histogram).
    Returns a list of S int64 arrays — identical to
    dominant_point_ids(components[s], labels[components[s]])[1] per s,
    given components[s] ascending (as partition/cp.py:84-86 writes them).
    """
    ids, counts = dominant_point_ids_flat(
        in_component, num_superpoints, labels, dominant)
    return np.split(ids, np.cumsum(counts)[:-1])


def dominant_point_ids_flat(in_component, num_superpoints, labels, dominant):
    """Arena form of dominant_point_ids_all: ONE flat id array instead of S
    Python list entries (the per-region object churn was the next scaling
    cliff at 1000-cloud scale — VERDICT r3 weak #5).

    Returns (ids [M] int64 — all dominant-label point ids, grouped by
    region in ascending region order and ascending id within a region —
    and counts [S] int64; region s owns ids[cum[s-1]:cum[s]])."""
    in_component = np.asarray(in_component)
    labels = np.asarray(labels)
    dominant = np.asarray(dominant)
    mask = labels == dominant[in_component]
    ids = np.flatnonzero(mask)
    seg = in_component[ids]
    order = np.argsort(seg, kind="stable")  # group by region, ids ascending
    ids = ids[order].astype(np.int64)
    counts = np.bincount(seg, minlength=num_superpoints)[:num_superpoints]
    return ids, counts.astype(np.int64)


def gt_dominant_all(in_component, num_superpoints, labels, num_classes):
    """Per-superpoint dominant GT label (host, vectorized): one flat
    bincount over combined (segment, class) keys instead of a Python loop.
    Ties break to the lowest class id, matching _dominant_label's np.argmax
    (sampler2.py:102-106). Returns [S] int64."""
    in_component = np.asarray(in_component, np.int64)
    labels = np.asarray(labels, np.int64)
    hist = np.bincount(
        in_component * num_classes + labels,
        minlength=num_superpoints * num_classes,
    ).reshape(num_superpoints, num_classes)
    return hist.argmax(axis=1)


def sub_regions_by_predicted_class(prob_class, point_inds):
    """Split a superpoint by predicted class; sampler2.py:117-122."""
    point_inds = np.asarray(point_inds)
    pred = np.asarray(prob_class)[point_inds]
    return [point_inds[pred == c] for c in range(int(pred.max()) + 1)]


def oracle_labeling(
    superpoint_inds: Sequence[int],
    components: List[np.ndarray],
    input_gt: np.ndarray,
    pseudo_gt: np.ndarray,
    stats: RoundStats,
    mode: str,
    prob_class,
    threshold: float,
    budget: Dict[str, int],
    min_size: int,
    selected_class_list: List[int],
):
    """Label the given superpoints until the click budget runs out.

    Parity with sampler2.py:124-192. Returns (pseudo_gt, used_superpoint_inds).
    pseudo_gt: float32 [2, N] (activation row 0, labels row 1), updated in place.
    """
    used = []

    if mode == "dominant":
        for sp_idx in superpoint_inds:
            if budget["click"] <= 0:
                break
            point_inds = components[sp_idx]
            if len(point_inds) < min_size:
                continue
            used.append(int(sp_idx))
            budget["click"] -= 1
            do_label, _ = dominant_label(input_gt[point_inds])
            pseudo_gt[0][point_inds] = 1.0
            pseudo_gt[1][point_inds] = float(do_label)
            selected_class_list.append(do_label)
            stats.sp_num += 1
            stats.p_num += len(point_inds)

    elif mode == "NAIL":
        if prob_class is None:
            # the NAIL annotator splits rejected superpoints by the MODEL's
            # predicted classes — samplers with no inference pass (random/
            # seed) cannot drive it. The reference has the same constraint,
            # but fails opaquely inside _get_sub_region_from_superpoint
            # (sampler2.py:117-122 with prob_class=None); its random
            # baselines use the dominant oracle (run_sota_comparison.sh).
            raise ValueError(
                "NAIL oracle requires model predictions (prob_class); "
                "use oracle_mode='dominant' for samplers without an "
                "inference pass (random/seed)")
        for sp_idx in superpoint_inds:
            if budget["click"] <= 0:
                break
            point_inds = components[sp_idx]
            if len(point_inds) < min_size:
                continue
            ignore = True
            used.append(int(sp_idx))
            budget["click"] -= 1
            do_label, do_rate = dominant_label(input_gt[point_inds])
            if do_rate >= threshold:
                pseudo_gt[0][point_inds] = 1.0
                pseudo_gt[1][point_inds] = float(do_label)
                selected_class_list.append(do_label)
                stats.sp_num += 1
                stats.p_num += len(point_inds)
                ignore = False
            else:
                # annotator rejects the whole superpoint; split it by the
                # model's predicted classes and confirm pure sub-regions
                for sub_pids in sub_regions_by_predicted_class(prob_class, point_inds):
                    if len(sub_pids) > min_size:
                        sub_label, sub_rate = dominant_label(input_gt[sub_pids])
                        if sub_rate >= threshold:
                            budget["click"] -= 1
                            pseudo_gt[0][sub_pids] = 1.0
                            pseudo_gt[1][sub_pids] = float(sub_label)
                            selected_class_list.append(sub_label)
                            stats.sub_num += 1
                            stats.sub_p_num += len(sub_pids)
                            ignore = False
                if not ignore:
                    stats.split_sp_num += 1
            if ignore:
                stats.ignore_sp_num += 1
    else:
        raise ValueError(f"unknown oracle mode {mode!r}")

    return pseudo_gt, used


def seed_labeling(
    superpoint_inds: Sequence[int],
    components: List[np.ndarray],
    input_gt: np.ndarray,
    pseudo_gt: np.ndarray,
    stats: RoundStats,
):
    """Seed-round precise per-point labeling (sampler2.py:218-245 _help_seed)."""
    for sp_idx in superpoint_inds:
        point_inds = components[sp_idx]
        pseudo_gt[0][point_inds] = 1.0
        pseudo_gt[1][point_inds] = input_gt[point_inds]
        stats.sp_num += 1
        stats.p_num += len(point_inds)
    return pseudo_gt
