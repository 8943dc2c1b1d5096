"""Segment reductions over a dense segment-id map (superpoints).

Counterpart of ssdr_al_tpu/ops/segment.py: count, sum, mean, max, min,
class histogram and majority with a static segment count. Ids outside
[0, num_segments) are dropped, as jax.ops.segment_sum drops them; an empty
segment's max / min is the identity of the reduction, as in JAX (−inf /
+inf for floats, the dtype's least / greatest value for integers).
"""

from __future__ import annotations

import torch


def _in_range(seg_ids, num_segments):
    return (seg_ids >= 0) & (seg_ids < num_segments)


def segment_count(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Points per segment, [S] int64."""
    ids = seg_ids.long()
    return torch.bincount(ids[_in_range(ids, num_segments)],
                          minlength=num_segments)[:num_segments]


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values [N, ...], seg_ids [N] → [S, ...] (sums in the values' dtype)."""
    ids = seg_ids.long()
    keep = _in_range(ids, num_segments)
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add_(0, ids[keep], values[keep])


def segment_mean(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment mean; an empty segment's is 0."""
    s = segment_sum(values, seg_ids, num_segments)
    c = torch.clamp(segment_count(seg_ids, num_segments), min=1).to(s.dtype)
    return s / c.reshape((-1,) + (1,) * (s.dim() - 1))


def _segment_extreme(values, seg_ids, num_segments, reduce):
    ids = seg_ids.long()
    keep = _in_range(ids, num_segments)
    if values.is_floating_point():
        fill = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(values.dtype)
        fill = info.min if reduce == "amax" else info.max
    out = values.new_full((num_segments,) + tuple(values.shape[1:]), fill)
    v = values[keep]
    index = ids[keep].reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
    return out.scatter_reduce_(0, index, v, reduce, include_self=True)


def segment_max(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values [N, ...], seg_ids [N] → [S, ...] per-segment maximum."""
    return _segment_extreme(values, seg_ids, num_segments, "amax")


def segment_min(values: torch.Tensor, seg_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """values [N, ...], seg_ids [N] → [S, ...] per-segment minimum."""
    return _segment_extreme(values, seg_ids, num_segments, "amin")


def segment_label_histogram(labels: torch.Tensor, seg_ids: torch.Tensor,
                            num_segments: int, num_classes: int):
    """Per-segment class histogram, [S, C] int64."""
    ids = seg_ids.long()
    keep = _in_range(ids, num_segments)
    key = ids[keep] * num_classes + labels.long()[keep]
    return torch.bincount(key, minlength=num_segments * num_classes)[
        : num_segments * num_classes].reshape(num_segments, num_classes)


def segment_majority(labels: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int, num_classes: int):
    """(dominant label [S] int32, dominance rate [S] f32). Ties go to the
    lowest class id (torch.argmax returns the first maximum, as np.argmax);
    empty segments get class 0 and rate 0."""
    hist = segment_label_histogram(labels, seg_ids, num_segments, num_classes)
    dominant = torch.argmax(hist, dim=1).to(torch.int32)
    count = hist.sum(1)
    rate = hist.amax(1).float() / count.clamp(min=1).float()
    return dominant, rate
