"""ssdr_al_torch's host data path and evaluation against the JAX package's:
the training and possibility-evaluation pipelines give identical batches
for the same seed, PLY files and clouds round-trip between the two, the
class weights and config lookup agree, and Evaluator / simple_evaluate give
the same mIoU and OA when fed the same fixed eval_step outputs (exact:
both sides fold the same float16 probabilities in the same order)."""

import numpy as np
import pytest
import torch

from ssdr_al_tpu import config as j_config
from ssdr_al_tpu.data import cloud as j_cloud
from ssdr_al_tpu.data import dataset as j_dataset
from ssdr_al_tpu.data import ply as j_ply
from ssdr_al_tpu.data import synthetic as j_syn
from ssdr_al_tpu.train import evaluator as j_eval
from ssdr_al_torch import config as t_config
from ssdr_al_torch.data import cloud as t_cloud
from ssdr_al_torch.data import dataset as t_dataset
from ssdr_al_torch.data import ply as t_ply
from ssdr_al_torch.train import evaluator as t_eval
from ssdr_al_torch.train import metrics as t_metrics
from torch_parity import small_cfg

torch.set_num_threads(1)


def _clouds(n_clouds=3, points=3000, seed=0):
    train, val = j_syn.make_dataset(num_train=n_clouds, num_val=1,
                                    num_points=points, seed=seed, hard=True)
    return train, val


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("with_pseudo", [False, True])
def test_training_pipeline_matches_jax(with_pseudo):
    """sample_batch and the prefetching batches() iterator: same clouds,
    same centres, same shuffles, same pseudo-GT for the same seed."""
    train, _ = _clouds()
    cfg = small_cfg(num_points=1024, noise_init=3.5)
    pseudo = None
    if with_pseudo:
        rng = np.random.RandomState(1)
        pseudo = {c.name: np.stack([
            (rng.rand(c.num_points) < 0.3).astype(np.float32),
            rng.randint(0, cfg.num_classes, c.num_points).astype(np.float32)])
            for c in train}
    tp = t_dataset.TrainingPipeline(train, cfg, pseudo_gt=pseudo, seed=7)
    jp = j_dataset.TrainingPipeline(train, cfg, pseudo_gt=pseudo, seed=7)
    _assert_batches_equal(tp.sample_batch(4), jp.sample_batch(4))
    got, want = list(tp.batches(3, 2)), list(jp.batches(3, 2))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_possibility_eval_pipeline_matches_jax():
    """Same blocks and the same possibility state after each batch; one
    cloud smaller than num_points takes the upsampling branch."""
    train, val = _clouds()
    small = j_cloud.Cloud("small", train[0].xyz[:600], train[0].colors[:600],
                          train[0].labels[:600])
    clouds = [val[0], small]
    cfg = small_cfg(num_points=1024)
    tp = t_dataset.PossibilityEvalPipeline(clouds, cfg, seed=3)
    jp = j_dataset.PossibilityEvalPipeline(clouds, cfg, seed=3)
    for _ in range(4):
        _assert_batches_equal(tp.get_batch(3), jp.get_batch(3))
        assert tp.min_possibility == jp.min_possibility
        assert tp.global_min == jp.global_min
        for a, b in zip(tp.possibility, jp.possibility):
            np.testing.assert_array_equal(a, b)


def test_ply_and_clouds_round_trip(tmp_path):
    """The port writes PLY files the JAX reader reads, and the other way
    round; load_clouds gives the same clouds, _proj.pkl included."""
    import pickle

    train, val = _clouds(n_clouds=2, points=2000)
    for i, c in enumerate(train + val):
        fields = [c.xyz, c.colors, c.labels.astype(np.int32)]
        names = ["x", "y", "z", "red", "green", "blue", "class"]
        writer = t_ply.write_ply if i % 2 == 0 else j_ply.write_ply
        assert writer(str(tmp_path / f"{c.name}.ply"), fields, names)
    proj = (np.arange(50) % val[0].num_points, np.zeros(50, np.int32))
    with open(tmp_path / f"{val[0].name}_proj.pkl", "wb") as f:
        pickle.dump(proj, f)
    for inc, exc in (("train", None), (None, "train")):
        got = t_cloud.load_clouds(str(tmp_path), include=inc, exclude=exc)
        want = j_cloud.load_clouds(str(tmp_path), include=inc, exclude=exc)
        assert [c.name for c in got] == [c.name for c in want]
        assert len(got) == (2 if inc else 1)
        for g, w in zip(got, want):
            for field in ("xyz", "colors", "labels", "proj_idx",
                          "full_labels"):
                a, b = getattr(g, field), getattr(w, field)
                if b is None:
                    assert a is None, field
                    continue
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b)
    raw_t = t_ply.read_ply(str(tmp_path / f"{train[1].name}.ply"))
    raw_j = j_ply.read_ply(str(tmp_path / f"{train[1].name}.ply"))
    assert raw_t.dtype == raw_j.dtype
    np.testing.assert_array_equal(raw_t, raw_j)


def test_class_weights_and_get_config_match_jax():
    np.testing.assert_array_equal(t_config.class_weights("S3DIS"),
                                  j_config.class_weights("S3DIS"))
    assert t_config.class_weights("S3DIS").dtype == np.float32
    assert t_config.CLASS_COUNTS["S3DIS"] == tuple(
        j_config.CLASS_COUNTS["S3DIS"])
    got, want = t_config.get_config("S3DIS"), j_config.get_config("S3DIS")
    for f in got.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_config.get_config("Semantic3D")


def test_metrics_match_jax():
    from ssdr_al_tpu.train import metrics as j_metrics

    rng = np.random.RandomState(2)
    labels = rng.randint(0, 6, 5000)
    preds = np.where(rng.rand(5000) < 0.7, labels, rng.randint(0, 6, 5000))
    labels[labels == 5] = 4                     # class 5 absent: backfilled
    got = t_metrics.confusion_matrix(labels, preds, 6)
    np.testing.assert_array_equal(got, j_metrics.confusion_matrix(
        labels, preds, 6))
    np.testing.assert_array_equal(t_metrics.iou_from_confusion(got),
                                  j_metrics.iou_from_confusion(got))


class _FixedStep:
    """The same eval_step outputs for both frameworks: probs = softmax of a
    fixed linear map of the features, in numpy; with `sorted_rows`, rows
    come back in a fixed per-batch order as the sorted path returns them."""

    def __init__(self, num_classes, sorted_rows, torch_side):
        self.m = np.random.RandomState(9).randn(6, num_classes).astype(
            np.float32)
        self.sorted_rows = sorted_rows
        self.torch_side = torch_side

    def __call__(self, state, batch):
        f = np.asarray(batch["features"], np.float32)
        logits = f @ self.m
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = (e / e.sum(-1, keepdims=True)).astype(np.float32)
        penult = f.copy()
        out = [probs, penult]
        if self.sorted_rows:
            b, n = f.shape[:2]
            rng = np.random.RandomState(int(f[0, 0, 0] * 1e4) % 1000)
            order = np.stack([rng.permutation(n) for _ in range(b)]).astype(
                np.int32)
            out = [np.take_along_axis(x, order[..., None], axis=1)
                   for x in out] + [order]
        if self.torch_side:
            out = [torch.from_numpy(np.ascontiguousarray(x)) for x in out]
        return tuple(out)


@pytest.mark.parametrize("sorted_rows", [False, True])
@pytest.mark.parametrize("proj", [False, True])
def test_evaluator_matches_jax(sorted_rows, proj):
    """Vote smoothing, the possibility schedule and its stop rule, and the
    sub-cloud confusion rescale or the val_proj reprojection; mIoU and OA
    equal (both fold the same float16 votes in the same order)."""
    _, val = _clouds(points=2500)
    other = j_syn.make_dataset(num_train=0, num_val=1, num_points=1800,
                               seed=4, hard=True)[1][0]
    clouds = [val[0], other]
    cfg = small_cfg(num_points=1024, val_batch_size=2, val_steps=3,
                    num_classes=j_syn.NUM_SYNTH_CLASSES_HARD)
    kw = {}
    if proj:
        rng = np.random.RandomState(5)
        kw = dict(val_proj=[rng.randint(0, c.num_points, 4000)
                            for c in clouds],
                  val_labels=[rng.randint(0, cfg.num_classes, 4000)
                              for c in clouds])
    for max_epochs in (1, 50):
        got = t_eval.Evaluator(cfg, clouds, seed=2, max_epochs=max_epochs,
                               **kw)(_FixedStep(cfg.num_classes, sorted_rows,
                                                True), None)
        want = j_eval.Evaluator(cfg, clouds, seed=2, max_epochs=max_epochs,
                                **kw)(_FixedStep(cfg.num_classes, sorted_rows,
                                                 False), None)
        assert got == want
        assert 0.0 < got[0] < 1.0 and 0.0 < got[1] < 1.0


@pytest.mark.parametrize("sorted_rows", [False, True])
@pytest.mark.parametrize("ignored", [(), (0,)])
def test_simple_evaluate_matches_jax(sorted_rows, ignored):
    _, val = _clouds(points=2500)
    cfg = small_cfg(num_points=1024)
    pipe = j_dataset.PossibilityEvalPipeline(val, cfg, seed=1)
    batches = [pipe.get_batch(2) for _ in range(3)]
    nc = 6
    got = t_eval.simple_evaluate(_FixedStep(nc, sorted_rows, True), None,
                                 batches, nc, ignored)
    want = j_eval.simple_evaluate(_FixedStep(nc, sorted_rows, False), None,
                                  batches, nc, ignored)
    assert got == want
