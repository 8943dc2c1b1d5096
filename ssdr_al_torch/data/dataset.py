"""Host-side input pipelines (a copy of ssdr_al_tpu/data/dataset.py, the
S3DIS part): random training blocks with a prefetch thread, whole-cloud
chunks for AL selection, and the possibility-scheduled evaluation
sampler. Neighbour indices are not computed here: the device builds them
per batch (models/randlanet.py::build_pyramid)."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from ssdr_al_torch.data.cloud import Block, Cloud, sample_block, stack_blocks


class TrainingPipeline:
    """Random spatially regular blocks from labelled clouds: every batch
    draws `batch_size` clouds from a reshuffled cycle, samples one block per
    cloud around a random centre, and attaches the round's pseudo-GT
    (activation and pseudo labels)."""

    def __init__(self, clouds: List[Cloud], cfg, *,
                 pseudo_gt: Optional[Dict[str, np.ndarray]] = None,
                 seed: int = 0):
        self.clouds = clouds
        self.cfg = cfg
        self.pseudo_gt = pseudo_gt  # {cloud_name: float32 [2, N]}
        self.rng = np.random.RandomState(seed)
        self._order = np.arange(len(clouds))
        self._pos = len(clouds)  # reshuffle on first use

    def _next_cloud(self) -> int:
        if self._pos >= len(self._order):
            self.rng.shuffle(self._order)
            self._pos = 0
        ci = int(self._order[self._pos])
        self._pos += 1
        return ci

    def sample_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        blocks = []
        for _ in range(batch_size):
            ci = self._next_cloud()
            cloud = self.clouds[ci]
            act, pseudo = None, None
            if self.pseudo_gt is not None:
                gt = self.pseudo_gt[cloud.name]
                act, pseudo = gt[0], gt[1]
            b = sample_block(
                cloud, self.cfg.num_points, self.rng,
                activation=act, pseudo=pseudo,
                noise_sigma=self.cfg.noise_init / 10,
            )
            b.cloud_idx = ci
            blocks.append(b)
        return stack_blocks(blocks)

    def batches(self, num_batches: int, batch_size: int,
                prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """`num_batches` batches, sampled ahead on a background thread."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = object()

        def worker():
            for _ in range(num_batches):
                q.put(self.sample_batch(batch_size))
            q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()


class SamplingPipeline:
    """Whole-cloud inference blocks for AL selection: every point of a
    cloud, cut by a shuffled partition into chunks of `chunk_points`, each
    padded by repeating its own points."""

    def __init__(self, clouds: List[Cloud], cfg, *, chunk_points=None,
                 seed: int = 0):
        self.clouds = clouds
        self.chunk_points = chunk_points or cfg.num_points
        self.rng = np.random.RandomState(seed)

    def cloud_chunks(self, cloud: Cloud):
        """Yield ({"xyz": [1, cp, 3], "features": [1, cp, 6]}, point_idx
        [cp], valid_count) covering the cloud; xyz is centred per chunk."""
        n = cloud.num_points
        cp = self.chunk_points
        perm = self.rng.permutation(n)
        for ci in range(max(1, -(-n // cp))):
            idx = perm[ci * cp: (ci + 1) * cp]
            valid = len(idx)
            if valid < cp:
                pad = (self.rng.choice(idx, cp - valid) if valid
                       else np.zeros(cp, np.int64))
                idx = np.concatenate([idx, pad])
            center = cloud.xyz[idx].mean(axis=0)
            xyz = cloud.xyz[idx] - center[None, :]
            feats = np.concatenate([xyz, cloud.colors[idx]], axis=1)
            yield ({"xyz": xyz[None].astype(np.float32),
                    "features": feats[None].astype(np.float32)}, idx, valid)


class PossibilityEvalPipeline:
    """Low-coverage-first evaluation sampler: each block is centred on the
    least-visited point of the least-visited cloud, and the visited points'
    possibility grows by (1 − d/d_max)²."""

    def __init__(self, clouds: List[Cloud], cfg, seed: int = 0):
        self.clouds = clouds
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.possibility = [self.rng.rand(c.num_points) * 1e-3
                            for c in clouds]
        self.min_possibility = [float(p.min()) for p in self.possibility]

    @property
    def global_min(self) -> float:
        return min(self.min_possibility)

    def get_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        blocks = []
        for _ in range(batch_size):
            ci = int(np.argmin(self.min_possibility))
            cloud = self.clouds[ci]
            pts = cloud.xyz
            point_ind = int(np.argmin(self.possibility[ci]))
            pick = pts[point_ind] + self.rng.normal(
                scale=cfg.noise_init / 10, size=3).astype(np.float32)

            if len(pts) < cfg.num_points:
                idx = np.arange(len(pts))
            else:
                d2all = np.sum((pts - pick[None]) ** 2, axis=1)
                idx = np.argpartition(d2all, cfg.num_points - 1)[
                    : cfg.num_points]
            self.rng.shuffle(idx)

            dists = np.sum((pts[idx] - pick[None]) ** 2, axis=1)
            delta = np.square(1 - dists / dists.max())
            self.possibility[ci][idx] += delta
            self.min_possibility[ci] = float(self.possibility[ci].min())

            if len(idx) < cfg.num_points:
                dup = self.rng.choice(len(idx), cfg.num_points - len(idx))
                idx = np.concatenate([idx, idx[dup]])

            xyz = (pts[idx] - pick[None]).astype(np.float32)
            feats = np.concatenate([xyz, cloud.colors[idx]], axis=1)
            blocks.append(Block(
                xyz=xyz,
                features=feats.astype(np.float32),
                labels=cloud.labels[idx].astype(np.int32),
                activation=np.zeros(len(idx), np.float32),
                pseudo=np.zeros(len(idx), np.int32),
                point_idx=idx.astype(np.int32),
                cloud_idx=ci,
            ))
        return stack_blocks(blocks)
