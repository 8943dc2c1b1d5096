"""Trainable GCN diversity reasoning: the coreGCN / uncertainGCN branch
(counterpart of ssdr_al_tpu/active/gcn.py; reference gcn.py:16-263):
  adjacency  A = (S−I)·diag(1/colsum(S−I)) + I, S = ⟨v̂_i, v̂_j⟩·exp(−(ED+CD))
             per cloud block                                (create_adj:116-191)
  model      gc1 → ReLU → dropout(0.3) → gc3 → sigmoid     (GCN.forward:74-78)
  loss       −mean log s_labeled − λ·mean log(1−s_unlabeled), λ = 1.2
  training   AdamW lr 1e-3, weight decay 5e-4, 20 000 steps (:213-226)
  selection  coreGCN: k-center greedy over concat(hidden, score) (:235-249)
             uncertainGCN: |score − 0.1| margin ranking     (:251-255)

Everything after the host bookkeeping runs on one device, the block
products in full f32 (JAX's Precision.HIGHEST). torch.optim.AdamW and
optax.adamw are both decoupled weight decay with bias-corrected moments.
On the card the fit is one device program, as JAX's jit of a lax.scan
is: GRAPH_WARMUP eager steps, then one step captured in a CUDA graph and
replayed for the rest. On the CPU it is a Python loop of the same steps,
the plain version. The initial weights and the dropout masks come from a
torch.Generator where JAX draws them from PRNGKey(seed): the same
distributions, other bits (`gcn_params_from_jax` carries JAX's weights
across).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ssdr_al_torch.active.region_graph import RegionGraph, flat_to_blocks
from ssdr_al_torch.device import DEFAULT_DEVICE, full_f32_matmul, resolve_device
from ssdr_al_torch.ops.kcenter import kcenter_greedy
# the fit on the card: GRAPH_WARMUP eager steps (they allocate the
# gradients and AdamW's state), then a graph of one step replayed
# (`python3 ssdr_al_torch/train/step_times.py --gcn-fit` times it against
# graphs of more steps and the eager steps)
from ssdr_al_torch.train.graphs import run_steps

NHID = 128  # gcn.py:208
PARAMS = ("gc1_w", "gc1_b", "gc3_w", "gc3_b", "lin_w", "lin_b")


def _latent_adjacency(ed_cd: torch.Tensor, mask: torch.Tensor,
                      feats: torch.Tensor):
    """create_adj (gcn.py:176-190) per block: (adj [C, S, S], v̂ [C, S, D]).
    feats [C, S, D] padded block features; column sums scale the columns,
    as the reference's adj_diag (S is symmetric)."""
    with full_f32_matmul():
        norm = torch.sqrt((feats * feats).sum(-1, keepdim=True))
        vhat = feats / torch.clamp(norm, min=1e-12)
        latent = torch.einsum("cid,cjd->cij", vhat, vhat)
    s = latent * torch.exp(-ed_cd)
    s = torch.where(mask[:, :, None] & mask[:, None, :], s, 0.0)
    diag = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)[None] \
        * mask[:, :, None]
    adj = s - diag
    col_sum = adj.sum(1)                                       # [C, S]
    d_inv = torch.where(col_sum != 0, 1.0 / col_sum, 0.0)
    return adj * d_inv[:, None, :] + diag, vhat


def _init_gcn_params(generator: torch.Generator, nfeat: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """U(−1/√fan_out, 1/√fan_out) as GraphConvolution.reset_parameters
    (gcn.py:32-36) and nn.Linear's default, drawn from `generator` on the
    CPU; leaves that require grad on `device`."""
    def u(shape, bound):
        x = torch.rand(shape, generator=generator) * (2 * bound) - bound
        return x.to(device).requires_grad_(True)

    b1 = 1.0 / np.sqrt(NHID)
    return {"gc1_w": u((nfeat, NHID), b1), "gc1_b": u((NHID,), b1),
            "gc3_w": u((NHID, 1), 1.0), "gc3_b": u((1,), 1.0),
            "lin_w": u((1, 1), 1.0), "lin_b": u((1,), 1.0)}


def gcn_params_from_jax(params, device: torch.device | str = "cpu"
                        ) -> Dict[str, torch.Tensor]:
    """JAX's GCN parameters (`_init_gcn_params`' dict of arrays) as the
    port's: f32 leaves that require grad, on `device`."""
    return {k: torch.tensor(np.asarray(params[k], np.float32),
                            device=device, requires_grad=True)
            for k in PARAMS}


def _gcn_forward(params, adj, x, mask,
                 dropout_gen: Optional[torch.Generator] = None,
                 dropout: float = 0.3):
    """(scores [C, S, 1], hidden [C, S, NHID]) = GCN(x, adj) (gcn.py:74-78);
    with dropout_gen, train-mode dropout on the hidden layer (mask drawn
    from it), the hidden features returned before it."""
    with full_f32_matmul():
        h = torch.einsum("cij,cjd->cid", adj, x @ params["gc1_w"]) \
            + params["gc1_b"]
        h = torch.relu(h)
        feat = h
        if dropout_gen is not None:
            keep = torch.rand(h.shape, generator=dropout_gen,
                              device=h.device) < 1.0 - dropout
            feat = torch.where(keep, h / (1.0 - dropout), 0.0)
        out = torch.einsum("cij,cjd->cid", adj, feat @ params["gc3_w"]) \
            + params["gc3_b"]
    return torch.sigmoid(out), h


def bce_adjacency_loss(scores, labeled, valid, n_lbl, n_unl, lam=1.2):
    """BCEAdjLoss (gcn.py:80-86): −Σ log s over the labeled regions / n_lbl
    − λ·Σ log(1 − s) over the unlabeled ones / n_unl."""
    s = torch.clamp(scores[..., 0], 1e-7, 1 - 1e-7)
    lnl = (torch.log(s) * labeled * valid).sum() / n_lbl
    lnu = (torch.log(1 - s) * (1 - labeled) * valid).sum() / n_unl
    return -lnl - lam * lnu


def fit_steps(params, adj, vhat, mask, labeled, *, num_steps: int,
              lr: float = 1e-3, weight_decay: float = 5e-4,
              lam: float = 1.2, dropout_gen: Optional[torch.Generator] = None):
    """(step, losses): step() is one AdamW step of the fit on the
    BCE-adjacency loss, updating `params` in place, with dropout masks from
    dropout_gen (None: dropout off); it writes its loss to losses
    [num_steps] at a device-side position that it then advances, so that a
    CUDA graph of it can be replayed. AdamW is capturable on CUDA tensors;
    the gradients are zeroed in place (set_to_none=False), as a graph
    needs them."""
    valid = mask.float()
    n_lbl = torch.clamp((labeled * valid).sum(), min=1.0)
    n_unl = torch.clamp(((1 - labeled) * valid).sum(), min=1.0)
    opt = torch.optim.AdamW([params[k] for k in PARAMS], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay,
                            capturable=adj.device.type == "cuda")
    losses = torch.empty(num_steps, device=adj.device)
    pos = torch.zeros(1, dtype=torch.int64, device=adj.device)

    def step():
        opt.zero_grad(set_to_none=False)
        scores, _ = _gcn_forward(params, adj, vhat, mask, dropout_gen)
        loss = bce_adjacency_loss(scores, labeled, valid, n_lbl, n_unl, lam)
        loss.backward()
        opt.step()
        losses.index_copy_(0, pos, loss.detach().reshape(1))
        pos.add_(1)

    return step, losses


def fit_gcn(params, adj, vhat, mask, labeled, *, num_steps: int,
            lr: float = 1e-3, weight_decay: float = 5e-4, lam: float = 1.2,
            dropout_gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """num_steps AdamW steps on the BCE-adjacency loss (fit_steps),
    updating `params` in place; dropout masks from dropout_gen (None:
    dropout off). Returns the losses [num_steps] on the device.

    CPU tensors take a Python loop of the steps. On CUDA tensors the
    first GRAPH_WARMUP steps run eagerly and the rest as replays of one
    captured step (train/graphs.py::run_steps); a capture that fails
    raises."""
    step, losses = fit_steps(params, adj, vhat, mask, labeled,
                             num_steps=num_steps, lr=lr,
                             weight_decay=weight_decay, lam=lam,
                             dropout_gen=dropout_gen)
    run_steps(step, num_steps, adj.device,
              generators=[dropout_gen] if dropout_gen is not None else [],
              name="fit_gcn")
    return losses


def gcn_sampling(
    graph: RegionGraph,
    features: np.ndarray,
    unlabeled_flags: np.ndarray,
    sampling_batch: int,
    *,
    core_gcn: bool = True,
    num_steps: int = 20000,
    lr: float = 1e-3,
    weight_decay: float = 5e-4,
    lam: float = 1.2,
    s_margin: float = 0.1,
    seed: int = 0,
    device: torch.device | str = DEFAULT_DEVICE,
    eager: bool = False,
) -> Dict[str, List[int]]:
    """GCN_sampling (gcn.py:193-263): fit the GCN on the region graph, then
    pick sampling_batch unlabeled regions. features [N, D] flat region
    features; unlabeled_flags [N]. Returns {cloud_name: [sp_idx]}.
    eager=True runs the k-center steps eagerly on the card too (the fit
    replays its graph either way)."""
    device = resolve_device(device)
    feats_flat = np.asarray(features, np.float32)
    mask = torch.from_numpy(graph.mask).to(device)
    blocks = torch.from_numpy(flat_to_blocks(graph, feats_flat)).to(device)
    adj, vhat = _latent_adjacency(torch.from_numpy(graph.ed_cd).to(device),
                                  mask, blocks)
    labeled = torch.from_numpy(flat_to_blocks(
        graph, (~unlabeled_flags).astype(np.float32)[:, None])[..., 0]
    ).to(device)
    gen = torch.Generator().manual_seed(seed)
    params = _init_gcn_params(gen, feats_flat.shape[1], device)
    dropout_gen = torch.Generator(device).manual_seed(seed)
    fit_gcn(params, adj, vhat, mask, labeled, num_steps=num_steps, lr=lr,
            weight_decay=weight_decay, lam=lam, dropout_gen=dropout_gen)
    with torch.no_grad():
        scores, hidden = _gcn_forward(params, adj, vhat, mask)
    blk = torch.from_numpy(graph.block_of.astype(np.int64)).to(device)
    slot = torch.from_numpy(graph.slot_of.astype(np.int64)).to(device)
    scores_flat, hidden_flat = scores[blk, slot, 0], hidden[blk, slot]

    unl_idx = np.where(unlabeled_flags)[0]
    sampling_batch = min(sampling_batch, len(unl_idx))
    if core_gcn:
        feat = torch.cat([hidden_flat, scores_flat[:, None]], 1).double()
        feat = torch.nan_to_num(feat, nan=1e-10, posinf=1e10,
                                neginf=-1e10).float()
        labeled_mask = torch.from_numpy(~unlabeled_flags).to(device)
        chosen = kcenter_greedy(feat, labeled_mask, int(sampling_batch),
                                eager=eager).cpu().numpy()
    else:
        margin = np.abs(scores_flat.cpu().numpy()[unl_idx] - s_margin)
        chosen = unl_idx[np.argsort(-margin)[-sampling_batch:]]
    file_list: Dict[str, List[int]] = {}
    for i in chosen:
        ref = graph.refs[int(i)]
        if not ref.is_labeled:
            file_list.setdefault(ref.cloud_name, []).append(ref.sp_idx)
    return file_list

