"""Generated rooms and the voxel-grid superpoints that stand in for
cut-pursuit in selection workloads (a copy of ssdr_al_tpu/data/
synthetic.py). Same random draws in the same order, so the same seed gives
the same arrays; tests/test_torch_data.py holds them equal to the JAX
package's.
"""

from __future__ import annotations

import numpy as np

from ssdr_al_torch.data.cloud import Cloud

# synthetic class ids: 0 floor, 1 ceiling, 2 wall, 3 box, 4 clutter; the
# hard rooms add 5 chair, 6 pillar, 7 board
NUM_SYNTH_CLASSES = 5
NUM_SYNTH_CLASSES_HARD = 8


# ------------------------------------------------------- synthetic rooms ---


def _plane(rng, n, extent, z, cls, jitter=0.02):
    xy = rng.rand(n, 2) * extent
    zz = np.full((n, 1), z) + rng.randn(n, 1) * jitter
    return np.hstack([xy, zz]), np.full(n, cls)


def _wall(rng, n, extent, height, axis, offset, cls, jitter=0.02):
    t = rng.rand(n) * extent
    z = rng.rand(n) * height
    w = np.full(n, offset) + rng.randn(n) * jitter
    pts = np.stack([t, w, z], axis=1) if axis == 1 else np.stack([w, t, z], axis=1)
    return pts, np.full(n, cls)


def _box(rng, n, center, size, cls):
    face = rng.randint(0, 6, n)
    u = rng.rand(n) - 0.5
    v = rng.rand(n) - 0.5
    pts = np.zeros((n, 3))
    for f in range(6):
        m = face == f
        ax = f // 2
        others = [a for a in range(3) if a != ax]
        pts[m, ax] = 0.5 if f % 2 == 0 else -0.5
        pts[m, others[0]] = u[m]
        pts[m, others[1]] = v[m]
    pts = pts * np.asarray(size)[None, :] + np.asarray(center)[None, :]
    return pts, np.full(n, cls)


def _blob(rng, n, center, scale, cls):
    pts = rng.randn(n, 3) * np.asarray(scale)[None, :] + np.asarray(center)[None, :]
    return pts, np.full(n, cls)


def _finish(rng, name, parts, colors_of):
    xyz = np.vstack([p for p, _ in parts]).astype(np.float32)
    labels = np.concatenate([l for _, l in parts]).astype(np.int32)
    colors = colors_of(xyz, labels)
    perm = rng.permutation(len(xyz))
    return Cloud(name=name, xyz=xyz[perm], colors=colors[perm],
                 labels=labels[perm])


def make_room(rng, name, *, num_points=20000, extent=6.0, height=3.0,
              num_boxes=3) -> Cloud:
    """Floor, ceiling, two walls and boxes; colours follow the class."""
    parts = []
    n_plane = num_points // 4
    parts.append(_plane(rng, n_plane, extent, 0.0, 0))
    parts.append(_plane(rng, n_plane, extent, height, 1))
    n_wall = num_points // 8
    parts.append(_wall(rng, n_wall, extent, height, 1, 0.0, 2))
    parts.append(_wall(rng, n_wall, extent, height, 1, extent, 2))
    n_box = max(1, (num_points - 2 * n_plane - 2 * n_wall) // max(num_boxes, 1))
    for _ in range(num_boxes):
        center = [rng.rand() * extent, rng.rand() * extent, rng.rand() * 1.0 + 0.4]
        size = rng.rand(3) * 0.8 + 0.4
        parts.append(_box(rng, n_box, center, size, 3))

    def colors_of(xyz, labels):
        palette = np.random.RandomState(1234).rand(NUM_SYNTH_CLASSES, 3) * 0.8 + 0.1
        c = palette[labels] + rng.randn(len(labels), 3) * 0.05
        return np.clip(c, 0, 1).astype(np.float32)

    return _finish(rng, name, parts, colors_of)


def make_room_hard(rng, name, *, num_points=20000, extent=6.0, height=3.0,
                   label_noise=0.03) -> Cloud:
    """Eight classes with confusable geometry and colours (chair vs box,
    pillar vs wall, board on a wall), rare classes and boundary label
    noise."""
    parts = []
    n_plane = num_points // 5
    parts.append(_plane(rng, n_plane, extent, 0.0, 0))
    parts.append(_plane(rng, n_plane, extent, height, 1))
    n_wall = num_points // 10
    parts.append(_wall(rng, n_wall, extent, height, 1, 0.0, 2))
    parts.append(_wall(rng, n_wall, extent, height, 1, extent, 2))
    parts.append(_wall(rng, n_wall, extent, height, 0, 0.0, 2))
    remaining = num_points - 2 * n_plane - 3 * n_wall
    n_box = remaining // 4
    for _ in range(3):
        c = [rng.rand() * extent, rng.rand() * extent, rng.rand() * 0.8 + 0.5]
        parts.append(_box(rng, n_box // 3, c, rng.rand(3) * 0.8 + 0.6, 3))
    n_chair = remaining // 6
    for _ in range(4):
        c = [rng.rand() * extent, rng.rand() * extent, rng.rand() * 0.3 + 0.25]
        parts.append(_box(rng, n_chair // 4, c, rng.rand(3) * 0.3 + 0.25, 5))
    n_clut = remaining // 6
    for _ in range(5):
        c = [rng.rand() * extent, rng.rand() * extent, rng.rand() * 0.6 + 0.2]
        parts.append(_blob(rng, n_clut // 5, c, [0.25, 0.25, 0.15], 4))
    n_pil = remaining // 8
    for _ in range(2):
        c = [rng.rand() * extent, rng.rand() * extent, height / 2]
        parts.append(_box(rng, n_pil // 2, c, [0.3, 0.3, height], 6))
    n_board = max(20, remaining // 16)
    for _ in range(2):
        c = [rng.rand() * extent, 0.04, rng.rand() * 1.0 + 1.0]
        parts.append(_box(rng, n_board // 2, c, [1.0, 0.06, 0.7], 7))

    def colors_of(xyz, labels):
        base = np.random.RandomState(1234).rand(NUM_SYNTH_CLASSES_HARD, 3) * 0.8 + 0.1
        base[5] = base[3] + 0.04
        base[6] = base[2] + 0.03
        base[7] = base[2] - 0.03
        c = np.clip(base[labels] + rng.randn(len(labels), 3) * 0.12, 0, 1)
        if label_noise > 0:
            # flip a share of labels to a nearby point's class, in place
            pick = rng.choice(len(labels), int(len(labels) * label_noise),
                              replace=False)
            d2 = np.sum((xyz[pick, None, :] -
                         xyz[None, rng.choice(len(xyz), 256), :]) ** 2, axis=-1)
            donor = rng.choice(len(xyz), 256)
            labels[pick] = labels[donor[np.argmin(d2, axis=1)]]
        return c.astype(np.float32)

    return _finish(rng, name, parts, colors_of)


def make_dataset(num_train=4, num_val=1, num_points=20000, seed=0,
                 hard=False):
    """(train, val) lists of generated rooms."""
    rng = np.random.RandomState(seed)
    room = make_room_hard if hard else make_room
    train = [room(rng, f"Room_train_{i}", num_points=num_points)
             for i in range(num_train)]
    val = [room(rng, f"Room_val_{i}", num_points=num_points)
           for i in range(num_val)]
    return train, val


def grid_superpoints(xyz, target_sp: int = 256):
    """O(N) voxel partition sized by bisection on the voxel edge to land
    near `target_sp` occupied voxels. Returns (components, in_component),
    components ascending per region."""
    xyz = np.asarray(xyz)
    lo = xyz.min(axis=0)
    span = float(np.maximum(xyz.max(axis=0) - lo, 1e-6).max())

    def part(v):
        q = np.floor((xyz - lo) / v).astype(np.int64)
        dims = q.max(axis=0) + 1
        key = (q[:, 0] * dims[1] + q[:, 1]) * dims[2] + q[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        return len(uniq), inv

    v_lo, v_hi = span / (4 * max(target_sp, 1)), span
    s, inv = part((v_lo * v_hi) ** 0.5)
    for _ in range(16):
        if 0.8 * target_sp <= s <= 1.25 * target_sp:
            break
        if s > target_sp:
            v_lo = (v_lo * v_hi) ** 0.5
        else:
            v_hi = (v_lo * v_hi) ** 0.5
        s, inv = part((v_lo * v_hi) ** 0.5)
    in_component = inv.astype(np.int32)
    order = np.argsort(in_component, kind="stable")
    bounds = np.searchsorted(in_component[order], np.arange(s + 1))
    return ([order[bounds[i]: bounds[i + 1]] for i in range(s)],
            in_component)
