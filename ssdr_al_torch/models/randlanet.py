"""RandLA-Net as torch.nn modules (counterpart of
ssdr_al_tpu/models/randlanet.py), with its training loss.

Architecture, parameter shapes and names follow the flax model, so
`params_from_flax` converts a JAX checkpoint into a `state_dict`:
  fc0 (6→8, BN, leaky ReLU 0.2)
  L × [DilatedResBlock → random_sample]   (mlp1 → LFA → mlp2 + shortcut)
  decoder_0 bottleneck, L × [nearest_interpolation → concat skip → SharedMLP]
  fc1 (64) → fc2 (32) = penultimate → fc (classes)
Every tensor is channels-last ([B, N, C] / [B, N, k, C]) as in JAX.

`build_pyramid` makes the per-layer neighbourhoods on the device, batched
over B: engine "window" builds the curve-sorted pyramid (K1 window search,
gathers through K2, whose backward is K4); "window_og" the original-order
pyramid of per-layer window searches (K1, plain gathers); "xla", "approx"
and "pallas" the exact original-order pyramid, whose searches are
`knn_xla` or, for "approx" and "pallas", kernel K6. On the card every row gather's
backward sums in a fixed order (K4, at k = 1 for the windowed upsamples,
or ops/gather.py::scatter_rows), so a train step repeats bit for bit.
`model.train()` switches
BatchNorm to batch statistics (flax's arithmetic, below) and turns on the
head's dropout, whose mask comes from the generator passed to forward;
`model.eval()` uses the running statistics and no dropout.

`cfg.compute_dtype` "bfloat16" runs the activations in bf16 as flax's
`dtype=` does (models/randlanet.py:516): parameters stay f32 and are cast
per call; every 1×1 conv multiplies in bf16 (`dense`), and its bias add
and BatchNorm (statistics included) run in f32 and round to bf16 once;
the attention softmax runs in f32; the windowed gathers take f32 values
and store bf16 (K2's bf16 output) and their backward reads a bf16
cotangent (K4); the penultimate features and the logits are f32. The
rounding points are those of the JAX model compiled for the CPU.
"float32" leaves every layer in its parameters' dtype.

TF32 is switched off below for matmuls and cuDNN: the JAX reference runs
in full f32 on the CPU, and a TF32 product keeps only ~3 decimal digits,
which the parity tolerances (rtol 1e-4 on logits) would not survive.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssdr_al_torch.config import Config
from ssdr_al_torch.ops.gather import (
    WindowTranspose,
    gather_rows_fixed,
    gather_window,
    gather_window_auto,
)
from ssdr_al_torch.ops.knn import (
    CURVES,
    QUERY_TILE,
    SortedCloud,
    gather_rows,
    invert_permutation,
    knn,
    knn_window_sorted,
    knn_window_sorted_raw,
    knn_xla,
    sort_by_codes,
    sort_cloud,
    window_topk,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# queries per gather tile on the sorted path (models/randlanet.py:_GATHER_TQ)
GATHER_TQ = 512
BN_EPS = 1e-6        # flax BatchNorm(epsilon=1e-6)
BN_MOMENTUM = 0.99   # flax BatchNorm(momentum=0.99): ra = 0.99·ra + 0.01·batch
DROPOUT_RATE = 0.5   # the head's nn.Dropout(0.5) before fc
# jax.nn.leaky_relu's weakly typed 0.2 takes the activation's dtype:
# in bf16 it is 0.2001953125
SLOPE_BF16 = float(torch.tensor(0.2, dtype=torch.bfloat16))
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    """The activation dtype of cfg.compute_dtype: None for "float32"
    (every layer in its parameters' dtype), torch.bfloat16."""
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}; options: "
                         f"{list(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[cfg.compute_dtype]


def leaky_relu(x):
    if x.dtype == torch.bfloat16:
        return torch.where(x >= 0, x, x * SLOPE_BF16)
    return F.leaky_relu(x, 0.2)


def dense(layer: nn.Linear, x, dtype: Optional[torch.dtype],
          bias_f32: bool = False):
    """layer(x) as flax's nn.Dense(dtype=dtype): input, kernel and bias
    cast to dtype, the product rounded to dtype, then the bias added in
    dtype, or with bias_f32 in f32 and left unrounded (as XLA fuses the
    add into the BatchNorm that follows). dtype None: the layer as it
    is."""
    if dtype is None:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    if layer.bias is None:
        return y
    b = layer.bias.to(dtype)
    return y.float() + b.float() if bias_f32 else y + b


def _at_least_f32(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def max_pool(pooled):
    """The max over the neighbour axis of [B, N', k, C] (random_sample)."""
    return pooled.amax(2)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis in flax 0.12's arithmetic:
    (x − mean) · (scale · rsqrt(var + eps)) + bias.

    Eval mode reads the running statistics. Train mode reduces over every
    axis but the last (the k axis of [B, N, k, C] edge tensors too) with
    flax's fast variance E[x²] − E[x]² clipped at 0, and updates the running
    statistics as ra = 0.99·ra + 0.01·batch with that BIASED variance
    (torch.nn.BatchNorm1d would take the unbiased one). The bf16 model
    feeds it f32 and rounds its output (SharedMLP), as flax's BatchNorm
    with dtype=bfloat16 keeps its statistics and arithmetic in f32.

    With a data-parallel `group` (set_data_group), train mode takes the
    statistics of the GLOBAL batch, as JAX's sharded BatchNorm does: the
    ranks' Σx and Σx² are all-reduced (differentiably, so the gradient of
    the statistics reaches every rank's rows) and divided by the global
    count, every rank's shard having the same shape; every rank then
    holds the same running statistics. torch.nn.SyncBatchNorm would take
    the unbiased running variance."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.group = None

    def _statistics(self, x):
        """(mean, biased variance) over every axis but the last."""
        if self.group is None:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            return mean, torch.clamp((x * x).mean(dims) - mean * mean,
                                     min=0.0)
        c = x.shape[-1]
        flat = x.reshape(-1, c)
        sums = self.group.all_reduce_sum(
            torch.cat([flat.sum(0), (flat * flat).sum(0)]), grad=True)
        count = flat.shape[0] * self.group.size
        mean = sums[:c] / count
        return mean, torch.clamp(sums[c:] / count - mean * mean, min=0.0)

    def forward(self, x):
        if self.training:
            mean, var = self._statistics(x)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    (1 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = self.weight * torch.rsqrt(var + BN_EPS)
        return (x - mean) * mul + self.bias


class Dropout(nn.Module):
    """flax nn.Dropout in train mode: keep with probability 1 − rate and
    scale kept values by 1 / (1 − rate); the identity in eval mode. The
    mask is drawn from the generator passed in, on x's device.

    With a data-parallel `group` (set_data_group) x is this rank's rows:
    every rank draws the GLOBAL batch's mask from a generator seeded alike
    and keeps its rows, so the shards' masks differ and together equal
    the single-device mask, as JAX's sharded dropout does."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.group = None

    def forward(self, x, generator: Optional[torch.Generator]):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("train-mode dropout needs a torch.Generator")
        keep_prob = 1.0 - self.rate
        m = 1 if self.group is None else self.group.size
        u = torch.rand((x.shape[0] * m,) + tuple(x.shape[1:]),
                       generator=generator, device=x.device,
                       dtype=_at_least_f32(x).dtype)
        keep = (u if self.group is None else
                self.group.shard_rows(u)) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class SharedMLP(nn.Module):
    """1×1 conv (+BN, +leaky ReLU) over the channel axis, in `dtype`
    (`dense`). In bf16 the product is rounded to bf16, the bias added and
    the BatchNorm applied in f32, and its output rounded to bf16 once: the
    rounding points of the JAX model's compiled bf16 layer."""

    def __init__(self, d_in: int, features: int, bn: bool = True,
                 act: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = nn.Linear(d_in, features)
        self.bn = BatchNorm(features) if bn else None
        self.act = act
        self.dtype = dtype

    def forward(self, x):
        x = dense(self.dense, x, self.dtype, bias_f32=self.bn is not None)
        if self.bn is not None:
            x = self.bn(x)
            if self.dtype is not None:
                x = x.to(self.dtype)
        return leaky_relu(x) if self.act else x


def gather_neighbour(pc, neighbor_idx):
    """pc [B, N, C], neighbor_idx [B, M, k] → [B, M, k, C] (row gather).
    On the card its backward sums each row in a fixed order
    (ops/gather.py::gather_rows_fixed), so a train step repeats bit for
    bit."""
    b, m, k = neighbor_idx.shape
    return gather_rows_fixed(pc, neighbor_idx.reshape(b, m * k)).reshape(
        b, m, k, pc.shape[-1])


def relative_pos_encoding(xyz, neigh_idx, neighbor_xyz=None):
    """10-d edge geometry [dist, rel_xyz, xyz, neigh_xyz]."""
    if neighbor_xyz is None:
        neighbor_xyz = gather_neighbour(xyz, neigh_idx)
    xyz_tile = xyz[:, :, None, :].expand_as(neighbor_xyz)
    relative_xyz = xyz_tile - neighbor_xyz
    relative_dis = torch.sqrt(torch.clamp(
        (relative_xyz ** 2).sum(-1, keepdim=True), min=1e-20))
    return torch.cat([relative_dis, relative_xyz, xyz_tile, neighbor_xyz], -1)


def random_sample(feature, pool_idx, window: int = 0):
    """Max-pool the k neighbours of each kept point. feature [B, N, C];
    pool_idx [B, N', k] → [B, N', C]. On the sorted path (window > 0) the
    gather goes through K2 with starts derived from the indices; a bf16
    feature is gathered from its f32 values into K2's bf16 output."""
    n, n_sub = feature.shape[1], pool_idx.shape[1]
    if window and n % 128 == 0 and n_sub % 128 == 0:
        dt = feature.dtype
        values = feature.float() if dt == torch.bfloat16 else feature
        pooled = gather_window_auto(values.contiguous(), pool_idx,
                                    min(window + 2048, n), out_dtype=dt)
    else:
        pooled = gather_neighbour(feature, pool_idx)
    return max_pool(pooled)


def nearest_interpolation(feature, interp_idx, window: int = 0):
    """feature [B, N', C]; interp_idx [B, N, 1] → [B, N, C] (row gather,
    ssdr_al_tpu/models/randlanet.py:160-167). window > 0: the indices came
    from the windowed 1-NN search, every tile's inside one window of that
    many rows, and an f32 feature is gathered by K2 at k = 1, whose
    backward is K4's binned scatter at k = 1 (deterministic; the same rows
    as torch.gather, bit for bit). Otherwise the row gather of
    gather_neighbour, whose backward on the card sums in a fixed order."""
    if window and feature.dtype == torch.float32:
        return gather_window_auto(feature.contiguous(), interp_idx,
                                  window)[:, :, 0]
    return gather_neighbour(feature, interp_idx)[:, :, 0]


class AttPooling(nn.Module):
    """Attentive pooling over the k neighbours; the softmax in at least
    f32, cast back (randlanet.py:180-182)."""

    def __init__(self, d: int, d_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = nn.Linear(d, d, bias=False)
        self.mlp = SharedMLP(d, d_out, dtype=dtype)
        self.dtype = dtype

    def forward(self, feature_set):
        att = dense(self.dense, feature_set, self.dtype)
        scores = torch.softmax(_at_least_f32(att), dim=2).to(
            feature_set.dtype)
        # the weighted sum of bf16 values in f32, rounded once (XLA's)
        agg = (_at_least_f32(feature_set) * _at_least_f32(scores)).sum(2)
        return self.mlp(agg.to(feature_set.dtype))


class BuildingBlock(nn.Module):
    """Local feature aggregation. On the sorted path (starts given) xyz and
    features are gathered together in one K2 call. In bf16 the gathers
    take f32 values and return bf16 (randlanet.py:206-209, 222-224), so
    the neighbours' xyz reach the edge geometry rounded to bf16, which is
    computed in f32 and cast to bf16 (:215)."""

    def __init__(self, d_in: int, d_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp1 = SharedMLP(10, d_in, dtype=dtype)
        self.att_pooling_1 = AttPooling(2 * d_in, d_out // 2, dtype)
        self.mlp2 = SharedMLP(d_in, d_out // 2, dtype=dtype)
        self.att_pooling_2 = AttPooling(d_out, d_out, dtype)
        self.dtype = dtype

    def _f32(self, x):
        return x if self.dtype is None else x.float()

    def forward(self, xyz, feature, neigh_idx, starts=None, window=0):
        if starts is not None:
            # both gathers' backward sums through one transpose of the
            # index set, built by the first of them to run (none without a
            # backward)
            tr = WindowTranspose(neigh_idx, starts, xyz.shape[1], window,
                                 GATHER_TQ) if torch.is_grad_enabled() \
                else None
            both = gather_window(torch.cat([xyz, self._f32(feature)], -1),
                                 neigh_idx, starts, window, GATHER_TQ,
                                 self.dtype, transpose=tr)
            neighbor_xyz, f_neighbours = both[..., :3], both[..., 3:]
        else:
            neighbor_xyz = None
            f_neighbours = gather_neighbour(feature, neigh_idx)
        f_xyz10 = relative_pos_encoding(xyz, neigh_idx, neighbor_xyz)
        f_xyz = self.mlp1(f_xyz10 if self.dtype is None
                          else f_xyz10.to(self.dtype))
        f_pc_agg = self.att_pooling_1(torch.cat([f_neighbours, f_xyz], -1))
        f_xyz = self.mlp2(f_xyz)
        if starts is not None:
            f_neighbours = gather_window(self._f32(f_pc_agg), neigh_idx,
                                         starts, window, GATHER_TQ,
                                         self.dtype, transpose=tr)
        else:
            f_neighbours = gather_neighbour(f_pc_agg, neigh_idx)
        return self.att_pooling_2(torch.cat([f_neighbours, f_xyz], -1))


class DilatedResBlock(nn.Module):
    def __init__(self, d_in: int, d_out: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp1 = SharedMLP(d_in, d_out // 2, dtype=dtype)
        self.lfa = BuildingBlock(d_out // 2, d_out, dtype)
        self.mlp2 = SharedMLP(d_out, 2 * d_out, act=False, dtype=dtype)
        self.shortcut = SharedMLP(d_in, 2 * d_out, act=False, dtype=dtype)

    def forward(self, feature, xyz, neigh_idx, starts=None, window=0):
        f_pc = self.mlp1(feature)
        f_pc = self.lfa(xyz, f_pc, neigh_idx, starts, window)
        return leaky_relu(self.mlp2(f_pc) + self.shortcut(feature))


@dataclasses.dataclass
class Pyramid:
    """Per-layer neighbourhoods in original point order."""

    xyz: List[torch.Tensor]          # [B, N_i, 3]
    neigh_idx: List[torch.Tensor]    # [B, N_i, k]
    sub_idx: List[torch.Tensor]      # [B, N_{i+1}, k]
    interp_idx: List[torch.Tensor]   # [B, N_i, 1]


@dataclasses.dataclass
class SortedPyramid:
    """Per-layer neighbourhoods in morton-sorted order. neigh_idx of gather
    tile t lies in [starts[t], starts[t] + windows[i]) where starts is not
    None. order: x_sorted = x[order]; inv: x = x_sorted[inv]."""

    xyz: List[torch.Tensor]
    neigh_idx: List[torch.Tensor]
    starts: List[Optional[torch.Tensor]]   # [B, N_i / GATHER_TQ] or None
    sub_idx: List[torch.Tensor]
    interp_idx: List[torch.Tensor]
    order: torch.Tensor                     # [B, N] int32
    inv: torch.Tensor                       # [B, N] int32
    windows: tuple = ()
    # the gather window of each layer's 1-NN upsample indices (0: they came
    # from the exact search)
    up_windows: tuple = ()


def _pyramid_sorted(xyz, cfg: Config) -> SortedPyramid:
    """Batched sorted pyramid (randlanet.py:350-460): one sort along
    cfg.curve at full resolution; each layer's order is its restriction to
    the kept subset."""
    b = xyz.shape[0]
    dev = xyz.device
    lo = xyz.amin(1, keepdim=True)
    hi = xyz.amax(1, keepdim=True)
    codes = CURVES[cfg.curve](xyz, lo, hi)
    _, order, cur_x = sort_by_codes(codes, xyz)
    inv = invert_permutation(order)
    cur_r = order                   # original-layer rank of each sorted row
    xyzs, neighs, starts_l, subs, interps, windows = [], [], [], [], [], []
    up_windows = []
    for i in range(cfg.num_layers):
        n = cur_x.shape[1]
        n_sub = n // cfg.sub_sampling_ratio[i]
        if n > 4096 and n % 256 == 0:
            if n % GATHER_TQ:
                raise ValueError(f"sorted pyramid: layer of {n} points is "
                                 f"not a multiple of {GATHER_TQ}")
            sw = cfg.search_window
            w = (sw if n > 16384 else sw // 2) - (GATHER_TQ - QUERY_TILE)
            sc = SortedCloud(cur_x, None, None, n)
            neigh, sts = knn_window_sorted_raw(sc, sc, cfg.k_n, window=w,
                                               self_query=True)
            # a gather tile merges GATHER_TQ/256 search tiles, so its window
            # widens by their start spread (self-query starts step ≤ 256)
            w_g = w + (GATHER_TQ - QUERY_TILE)
            sts = torch.clamp(sts[:, :: GATHER_TQ // QUERY_TILE],
                              max=n - w_g).contiguous()
            w = w_g
        elif 2048 <= n <= 4096 and n % GATHER_TQ == 0:
            # the window covers the whole sorted layer
            sc = SortedCloud(cur_x, None, None, n)
            neigh, _ = knn_window_sorted_raw(sc, sc, cfg.k_n, window=n,
                                             self_query=True)
            sts = torch.zeros((b, n // GATHER_TQ), dtype=torch.int32,
                              device=dev)
            w = n
        else:
            neigh = knn_xla(cur_x, cur_x, cfg.k_n)
            sts, w = None, 0
        # kept subset = first n_sub points of the ORIGINAL order, in sorted
        # position order
        kept = cur_r < n_sub
        ar = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
        kept_pos = torch.sort(torch.where(kept, ar, n), dim=1).values[:, :n_sub]
        nxt_x = gather_rows(cur_x, kept_pos).contiguous()
        nxt_r = gather_rows(cur_r, kept_pos)
        pool_i = gather_rows(neigh, kept_pos).contiguous()
        if n_sub > 2048 and n % 256 == 0 and n_sub % 128 == 0:
            # 1-NN upsample: each query's rank in the kept subset is an
            # exact cumsum, so tile starts need no search
            up_w = 1024
            ranks = torch.cumsum(kept.to(torch.int32), 1) - 1
            centers = torch.arange(n // QUERY_TILE, device=dev) * QUERY_TILE \
                + QUERY_TILE // 2
            starts_up = torch.clamp(ranks[:, centers] - up_w // 2, 0,
                                    n_sub - up_w)
            starts_up = ((starts_up // 128) * 128).to(torch.int32).contiguous()
            rel = window_topk(nxt_x, cur_x.contiguous(), starts_up, 1, up_w)
            up = torch.clamp(torch.repeat_interleave(starts_up, QUERY_TILE, 1)
                             [..., None] + rel, max=n_sub - 1)
        else:
            up_w = 0
            up = knn_xla(nxt_x, cur_x, 1)
        xyzs.append(cur_x)
        neighs.append(neigh.contiguous())
        starts_l.append(sts)
        subs.append(pool_i)
        interps.append(up)
        windows.append(w)
        # a 128-row gather tile of the upsample starts at its least index
        # rounded down to 128 (gather_window_auto), up to 127 rows before
        # its search window's start: 128 rows of slack keep every index
        # inside (window_violations 0)
        up_windows.append(up_w + 128 if up_w else 0)
        cur_x, cur_r = nxt_x, nxt_r
    return SortedPyramid(xyzs, neighs, starts_l, subs, interps, order, inv,
                         windows=tuple(windows), up_windows=tuple(up_windows))


def _pyramid_window_og(xyz, cfg: Config) -> Pyramid:
    """Window-search pyramid in original order (randlanet.py:299-347,
    engine "window_og"): each big layer is sorted once along cfg.curve and
    that view serves its self-search (window 4096 above 16384 points, else
    2048) and, as the query cloud, the next layer's 1-NN upsample search
    (window 1024); layers of ≤ 4096 points (or kept subsets of ≤ 2048)
    take knn_xla."""
    lo = xyz.amin(1, keepdim=True)
    hi = xyz.amax(1, keepdim=True)
    xyzs, neighs, subs, interps = [], [], [], []
    cur, sorted_cur = xyz, None
    for i in range(cfg.num_layers):
        n = cur.shape[1]
        n_sub = n // cfg.sub_sampling_ratio[i]
        if n > 4096:
            if sorted_cur is None:
                sorted_cur = sort_cloud(cur, lo, hi, curve=cfg.curve)
            neigh = knn_window_sorted(sorted_cur, sorted_cur, cfg.k_n,
                                      window=4096 if n > 16384 else 2048,
                                      self_query=True)
        else:
            neigh = knn_xla(cur, cur, cfg.k_n)
        sub_points = cur[:, :n_sub]
        if n_sub > 2048:
            sorted_sub = sort_cloud(sub_points, lo, hi, curve=cfg.curve)
            if sorted_cur is None:
                sorted_cur = sort_cloud(cur, lo, hi, curve=cfg.curve)
            up = knn_window_sorted(sorted_sub, sorted_cur, 1, window=1024)
        else:
            sorted_sub = None
            up = knn_xla(sub_points, cur, 1)
        xyzs.append(cur)
        neighs.append(neigh)
        subs.append(neigh[:, :n_sub])
        interps.append(up)
        cur, sorted_cur = sub_points, sorted_sub
    return Pyramid(xyzs, neighs, subs, interps)


def _pyramid_exact(xyz, cfg: Config, engine: str) -> Pyramid:
    """The generic pyramid (randlanet.py:484-498): every layer's self-search
    and upsample through knn(..., engine)."""
    xyzs, neighs, subs, interps = [], [], [], []
    cur = xyz
    for i in range(cfg.num_layers):
        n_sub = cur.shape[1] // cfg.sub_sampling_ratio[i]
        neigh = knn(cur, cur, cfg.k_n, engine=engine)
        sub_points = cur[:, :n_sub]
        xyzs.append(cur)
        neighs.append(neigh)
        subs.append(neigh[:, :n_sub])
        interps.append(knn(sub_points, cur, 1, engine=engine))
        cur = sub_points
    return Pyramid(xyzs, neighs, subs, interps)


KNN_ENGINES = ("window", "window_og", "xla", "approx", "pallas")


def build_pyramid(xyz: torch.Tensor, cfg: Config, *, engine: str = "window"):
    """Per-layer neighbourhoods of xyz [B, N, 3] (already shuffled, so the
    prefix of each layer is RandLA-Net's random subsample), as JAX builds
    them on the TPU.

    engine "window": SortedPyramid through the window search (K1 on CUDA,
    its plain version on CPU). "window_og": Pyramid in original order from
    per-layer window searches. "xla", "approx", "pallas": exact Pyramid in
    original order ("approx" is served exactly: it and "pallas" search
    with K6)."""
    xyz = xyz.float().contiguous()
    if engine == "window":
        return _pyramid_sorted(xyz, cfg)
    if engine == "window_og":
        return _pyramid_window_og(xyz, cfg)
    if engine in ("xla", "approx", "pallas"):
        return _pyramid_exact(xyz, cfg, engine)
    raise ValueError(f"unknown knn engine {engine!r}; options: {KNN_ENGINES}")


class RandLANet(nn.Module):
    """forward(features, pyramid) → (logits [B, N, C], penultimate [B, N, 32])."""

    def __init__(self, cfg: Config, d_feature: int = 6):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
        self.fc0 = nn.Linear(d_feature, 8)
        self.fc0_bn = BatchNorm(8)
        enc, d = [], 8
        widths = []
        for i in range(cfg.num_layers):
            enc.append(DilatedResBlock(d, cfg.d_out[i], dt))
            d = 2 * cfg.d_out[i]
            widths.append(d)
        self.encoder = nn.ModuleList(enc)
        skips = [widths[0]] + widths          # f_encoder_list channel widths
        dec = [SharedMLP(skips[-1], skips[-1], dtype=dt)]
        cur = skips[-1]
        for j in range(cfg.num_layers):
            skip = skips[-j - 2]
            dec.append(SharedMLP(skip + cur, skip, dtype=dt))
            cur = skip
        self.decoder = nn.ModuleList(dec)
        self.fc1 = SharedMLP(cur, 64, dtype=dt)
        self.fc2 = SharedMLP(64, 32, dtype=dt)
        self.dp1 = Dropout(DROPOUT_RATE)
        self.fc = nn.Linear(32, cfg.num_classes)

    def forward(self, features, pyramid, unsort: bool = True,
                generator: Optional[torch.Generator] = None):
        """generator draws the dropout mask in train mode; unsort=False on
        a sorted pyramid leaves the outputs in morton-sorted row order."""
        sorted_mode = isinstance(pyramid, SortedPyramid)
        if sorted_mode:
            features = gather_rows(features, pyramid.order)
        f = self.fc0_bn(dense(
            self.fc0, features.to(self.dtype or self.fc0.weight.dtype),
            self.dtype, bias_f32=True))
        f = leaky_relu(f if self.dtype is None else f.to(self.dtype))
        f_encoder_list = []
        for i, enc in enumerate(self.encoder):
            starts = pyramid.starts[i] if sorted_mode else None
            window = pyramid.windows[i] if sorted_mode else 0
            f_enc = enc(f, pyramid.xyz[i], pyramid.neigh_idx[i], starts,
                        window)
            f = random_sample(f_enc, pyramid.sub_idx[i], window)
            if i == 0:
                f_encoder_list.append(f_enc)
            f_encoder_list.append(f)
        f = self.decoder[0](f)
        up_windows = pyramid.up_windows if sorted_mode else ()
        for j in range(self.cfg.num_layers):
            f_interp = nearest_interpolation(
                f, pyramid.interp_idx[-j - 1],
                up_windows[-j - 1] if up_windows else 0)
            f = self.decoder[j + 1](
                torch.cat([f_encoder_list[-j - 2], f_interp], -1))
        f = self.fc2(self.fc1(f))
        penultimate = _at_least_f32(f)
        logits = self.fc(_at_least_f32(self.dp1(f, generator)))
        if sorted_mode and unsort:
            logits = gather_rows(logits, pyramid.inv)
            penultimate = gather_rows(penultimate, pyramid.inv)
        return logits, penultimate


def label_reduce_table(num_classes: int, ignored_label_inds) -> np.ndarray:
    """Raw-label → training-label lookup (reference RandLANet.py:66-71)."""
    reducing = list(range(num_classes))
    for ign in ignored_label_inds:
        reducing = reducing[:ign] + [0] + reducing[ign:]
    return np.asarray(reducing, dtype=np.int32)


def _on(x, dtype, device):
    """A numpy array, sequence or tensor as a tensor on `device`."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


def set_data_group(model: nn.Module, group):
    """Give every BatchNorm and Dropout of `model` the data-parallel group
    whose global batch its statistics and its mask cover (None: this
    process's batch)."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.group = group


def masked_weighted_ce(logits, pseudo, activation, labels, class_weights,
                       ignored_label_inds=(), reduce_table=None, group=None):
    """Activation-masked, class-weighted softmax CE, as
    ssdr_al_tpu/models/randlanet.py::masked_weighted_ce: points whose TRUE
    label is ignored are dropped, pseudo labels go through the reduce
    table, and ce · class_weight[pseudo] · activation is averaged over the
    valid points. logits [B, N, C]; pseudo / labels [B, N] int;
    activation [B, N] {0, 1}; class_weights and reduce_table numpy or
    tensors. Returns (loss, accuracy): top-1 against the TRUE labels on
    valid points.

    With a data-parallel `group` the logits are this rank's rows and the
    denominator is the GLOBAL valid count (each rank's shard may hold a
    different number of ignored labels): the returned loss is this rank's
    share of the global loss, whose gradients the ranks sum; the accuracy
    is the global one."""
    c = logits.shape[-1]
    logits2 = logits.reshape(-1, c)
    pseudo = pseudo.reshape(-1).long()
    labels = labels.reshape(-1).long()
    activation = activation.reshape(-1).float()
    valid = torch.ones_like(labels, dtype=torch.bool)
    for ign in ignored_label_inds:
        valid &= labels != ign
    if reduce_table is not None:
        table = _on(reduce_table, torch.long, logits.device)
        pseudo, labels = table[pseudo], table[labels]
    logp = F.log_softmax(logits2, dim=-1)
    ce = -logp.gather(1, pseudo[:, None])[:, 0]
    w = _on(class_weights, logits2.dtype, logits.device)[pseudo]
    count = valid.sum()
    correct = ((logits2.argmax(-1) == labels) & valid).sum()
    if group is not None:
        count, correct = group.all_reduce_sum(torch.stack([count, correct]))
    denom = torch.clamp(count, min=1)
    loss = (ce * w * activation * valid).sum() / denom
    return loss, correct / denom


def init_params(cfg: Config, generator: torch.Generator,
                d_feature: int = 6) -> dict:
    """Fresh weights as a CPU state_dict, drawn from `generator` with the
    flax initializers: 1×1 convs (SharedMLP, fc) truncated normal σ=1e-3
    cut at ±2σ, the dense layers (fc0, attention) glorot uniform, biases 0,
    BatchNorm scale 1 / bias 0 / mean 0 / var 1."""
    model = RandLANet(cfg, d_feature)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SharedMLP):
                nn.init.trunc_normal_(m.dense.weight, std=1e-3, a=-2e-3,
                                      b=2e-3, generator=generator)
                nn.init.zeros_(m.dense.bias)
            elif isinstance(m, AttPooling):
                nn.init.xavier_uniform_(m.dense.weight, generator=generator)
        nn.init.xavier_uniform_(model.fc0.weight, generator=generator)
        nn.init.zeros_(model.fc0.bias)
        nn.init.trunc_normal_(model.fc.weight, std=1e-3, a=-2e-3, b=2e-3,
                              generator=generator)
        nn.init.zeros_(model.fc.bias)
    return model.state_dict()


def _flax_shared(p, bs, prefix, out):
    out[prefix + "dense.weight"] = np.asarray(p["Dense_0"]["kernel"]).T
    out[prefix + "dense.bias"] = np.asarray(p["Dense_0"]["bias"])
    if "BatchNorm_0" in p:
        _flax_bn(p["BatchNorm_0"], bs["BatchNorm_0"], prefix + "bn.", out)


def _flax_bn(p, bs, prefix, out):
    out[prefix + "weight"] = np.asarray(p["scale"])
    out[prefix + "bias"] = np.asarray(p["bias"])
    out[prefix + "running_mean"] = np.asarray(bs["mean"])
    out[prefix + "running_var"] = np.asarray(bs["var"])


def _flax_att(p, bs, prefix, out):
    out[prefix + "dense.weight"] = np.asarray(p["Dense_0"]["kernel"]).T
    _flax_shared(p["mlp"], bs["mlp"], prefix + "mlp.", out)


def params_from_flax(params: dict, batch_stats: dict) -> dict:
    """Flax RandLANet variables (nested dicts of arrays) → state_dict.
    Dense kernels [in, out] become Linear weights [out, in]."""
    out = {}
    out["fc0.weight"] = np.asarray(params["fc0"]["kernel"]).T
    out["fc0.bias"] = np.asarray(params["fc0"]["bias"])
    _flax_bn(params["fc0_bn"], batch_stats["fc0_bn"], "fc0_bn.", out)
    i = 0
    while f"encoder_{i}" in params:
        p, bs, pre = params[f"encoder_{i}"], batch_stats[f"encoder_{i}"], \
            f"encoder.{i}."
        for name in ("mlp1", "mlp2", "shortcut"):
            _flax_shared(p[name], bs[name], pre + name + ".", out)
        lp, lbs = p["lfa"], bs["lfa"]
        for name in ("mlp1", "mlp2"):
            _flax_shared(lp[name], lbs[name], pre + f"lfa.{name}.", out)
        for name in ("att_pooling_1", "att_pooling_2"):
            _flax_att(lp[name], lbs[name], pre + f"lfa.{name}.", out)
        i += 1
    j = 0
    while f"decoder_{j}" in params:
        _flax_shared(params[f"decoder_{j}"], batch_stats[f"decoder_{j}"],
                     f"decoder.{j}.", out)
        j += 1
    for name in ("fc1", "fc2"):
        _flax_shared(params[name], batch_stats[name], name + ".", out)
    out["fc.weight"] = np.asarray(params["fc"]["kernel"]).T
    out["fc.bias"] = np.asarray(params["fc"]["bias"])
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}
