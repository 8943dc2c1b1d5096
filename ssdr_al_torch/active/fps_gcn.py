"""Parameter-free GCN-FPS diversity reasoning (counterpart of
ssdr_al_tpu/active/fps_gcn.py; reference fps_gcn_cpu.py):
  A = D⁻¹(S−I)+I with S = exp(−(ED+CD)) per cloud block,
  V_combined = Σ_{i=0..hops} Aⁱ V,
  farthest-feature sampling over the unlabeled regions.
Everything after the host bookkeeping runs on one device; the propagation
matmul is full f32 (TF32 is off, models/randlanet.py), as JAX's HIGHEST.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ssdr_al_torch.active.region_graph import RegionGraph, flat_to_blocks
from ssdr_al_torch.device import DEFAULT_DEVICE, resolve_device
from ssdr_al_torch.ops.fps import farthest_feature_sample


def _normalize_adjacency(ed_cd: torch.Tensor, mask: torch.Tensor,
                         gcn_top: int) -> torch.Tensor:
    """S = exp(−(ED+CD)) masked → A = (S−I)·diag(1/rowsum(S−I)) + I, with
    the reference's column scaling and inf→0 guard (fps_gcn_cpu.py:102-116);
    gcn_top > 0 keeps each row's gcn_top largest entries first."""
    s = torch.exp(-ed_cd)
    pair = mask[:, :, None] & mask[:, None, :]
    s = torch.where(pair, s, 0.0)
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)[None]
    valid_diag = eye * mask[:, :, None].to(s.dtype)
    adj = s - valid_diag
    if gcn_top > 0:
        thresh = torch.topk(adj, gcn_top, dim=-1).values[..., -1:]
        adj = torch.where(adj >= thresh, adj, 0.0)
    row_sum = adj.sum(-1)
    d_inv = torch.where(row_sum != 0, 1.0 / row_sum, 0.0)
    return adj * d_inv[:, None, :] + valid_diag


def _propagate(adj: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
               hops: int) -> torch.Tensor:
    """Σ_{i=0..hops} Aⁱ V per block."""
    feats = torch.where(mask[:, :, None], feats, 0.0)
    total, v = feats, feats
    for _ in range(hops):
        v = torch.bmm(adj, v)
        total = total + v
    return total


def gcn_fps_sampling(
    graph: RegionGraph,
    features: np.ndarray,
    unlabeled_flags: np.ndarray,
    sampling_batch: int,
    *,
    gcn_number: int = 1,
    gcn_top: int = 0,
    rng: np.random.RandomState | None = None,
    device: torch.device | str = DEFAULT_DEVICE,
) -> Dict[str, List[int]]:
    """GCN_FPS_sampling (fps_gcn_cpu.py:150-178).

    features [N, D] flat region features (penultimate means); unlabeled
    flags [N] mark the selectable candidates; the first pick is drawn from
    the caller's numpy RandomState. Returns {cloud_name: [sp_idx]}."""
    device = resolve_device(device)
    rng = rng or np.random.RandomState()
    if not np.any(unlabeled_flags) or sampling_batch <= 0:
        return {}      # exhausted pool: nothing to select
    blocks = flat_to_blocks(graph, np.asarray(features, np.float32))
    unl_idx = np.where(unlabeled_flags)[0]
    sampling_batch = min(sampling_batch, len(unl_idx))
    start = rng.randint(0, len(unl_idx))

    mask = torch.from_numpy(graph.mask).to(device)
    adj = _normalize_adjacency(torch.from_numpy(graph.ed_cd).to(device),
                               mask, int(gcn_top))
    combined = _propagate(adj, torch.from_numpy(blocks).to(device), mask,
                          int(gcn_number))
    blk = torch.from_numpy(graph.block_of[unl_idx].astype(np.int64)).to(device)
    slot = torch.from_numpy(graph.slot_of[unl_idx].astype(np.int64)).to(device)
    sel = farthest_feature_sample(combined[blk, slot], int(start),
                                  int(sampling_batch)).cpu().numpy()
    file_list: Dict[str, List[int]] = {}
    for i in unl_idx[sel]:
        ref = graph.refs[i]
        file_list.setdefault(ref.cloud_name, []).append(ref.sp_idx)
    return file_list
