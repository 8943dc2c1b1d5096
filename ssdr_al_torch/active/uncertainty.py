"""Point and region uncertainty, class-balance reweighting (counterpart of
ssdr_al_tpu/active/uncertainty.py). Point and region scores are torch on
the caller's device; the class-balance weights stay numpy, as in JAX."""

from __future__ import annotations

import numpy as np
import torch

from ssdr_al_torch.ops.segment import (
    segment_count,
    segment_label_histogram,
    segment_majority,
    segment_sum,
)


def point_uncertainty(probs: torch.Tensor, mode: str) -> torch.Tensor:
    """probs [..., C] softmax probabilities → [...] uncertainty.
    lc: 1 − max p; entropy: −Σ p·log2 p (0·log 0 := 0); sb: second / best."""
    if mode == "lc":
        return 1.0 - probs.amax(-1)
    if mode == "entropy":
        logp = torch.where(probs > 0, torch.log2(probs.clamp(min=1e-38)), 0.0)
        return -(probs * logp).sum(-1)
    if mode == "sb":
        top2 = torch.topk(probs, 2, dim=-1).values
        return top2[..., 1] / top2[..., 0]
    raise ValueError(f"unknown point_uncertainty mode {mode!r}")


def region_uncertainty(point_unc, point_class, seg_ids, num_segments: int,
                       num_classes: int, mode: str) -> torch.Tensor:
    """Per-superpoint uncertainty [S] f32 from per-point scores.
    mean: mean point score; sum_weight: Σ freq(class in region)·u;
    WetSU: Σ over dominant-class points − Σ over the others."""
    point_unc = point_unc.float()
    if mode == "mean":
        safe = segment_count(seg_ids, num_segments).clamp(min=1).float()
        return segment_sum(point_unc, seg_ids, num_segments) / safe
    if mode == "sum_weight":
        safe = segment_count(seg_ids, num_segments).clamp(min=1).float()
        hist = segment_label_histogram(point_class, seg_ids, num_segments,
                                       num_classes)
        freq = hist.float() / safe[:, None]
        w = freq[seg_ids.long().clamp(max=num_segments - 1),
                 point_class.long()]
        return segment_sum(w * point_unc, seg_ids, num_segments)
    if mode == "WetSU":
        dominant, _ = segment_majority(point_class, seg_ids, num_segments,
                                       num_classes)
        seg = seg_ids.long().clamp(max=num_segments - 1)
        is_dom = (point_class.long() == dominant[seg].long()).float()
        dom_sum = segment_sum(point_unc * is_dom, seg_ids, num_segments)
        other = segment_sum(point_unc * (1.0 - is_dom), seg_ids, num_segments)
        return dom_sum - other
    raise ValueError(f"unknown region uncertainty mode {mode!r}")


def _class_frequency_weights(class_list, num_classes):
    """Per-element frequency of its class (sampler2.py:92-100)."""
    class_list = np.asarray(class_list, np.int64)
    dist = np.bincount(class_list, minlength=num_classes).astype(np.float64)
    dist = dist / max(len(class_list), 1)
    return dist[class_list]


def add_classbal(num_classes, region_class, region_unc):
    """u · exp(−freq(region's class)) (sampler2.py:257-260)."""
    w = _class_frequency_weights(region_class, num_classes)
    return np.asarray(region_unc) * np.exp(-w)


def add_clsbal(num_classes, region_class, region_unc, selected_class_list):
    """classbal with the frequency also counting earlier selections'
    classes (sampler2.py:262-266)."""
    combined = list(np.asarray(region_class)) + list(selected_class_list)
    w = _class_frequency_weights(combined, num_classes)[: len(region_unc)]
    return np.asarray(region_unc) * np.exp(-w)
