"""The port's small public names against ssdr_al_tpu on the CPU: logging
(log_out, Timer, MetricsWriter, device_trace), six-fold cross-validation,
the colored PLY exporters and S3DIS_LABELS."""

import json
import os

import numpy as np
import pytest
import torch

import ssdr_al_tpu.utils.logging as jl
from ssdr_al_tpu import config as jc
from ssdr_al_tpu.train import cross_val as jcv
from ssdr_al_tpu.utils import visualize as jv
from ssdr_al_torch import config as tc
from ssdr_al_torch import utils as tu
from ssdr_al_torch.train import cross_val as tcv
from ssdr_al_torch.utils import logging as tl
from ssdr_al_torch.utils import visualize as tv

torch.set_num_threads(1)


def test_s3dis_labels_equal():
    assert tc.S3DIS_LABELS == jc.S3DIS_LABELS


def test_utils_exports_the_jax_names():
    assert (tu.log_out, tu.Timer, tu.MetricsWriter) == \
        (tl.log_out, tl.Timer, tl.MetricsWriter)


@pytest.mark.parametrize("n,bright,seed", [(13, True, 0), (8, False, 3),
                                           (1024, True, 5)])
def test_random_colors_equal(n, bright, seed):
    np.testing.assert_array_equal(tv.random_colors(n, bright, seed),
                                  jv.random_colors(n, bright, seed))


def test_label_and_superpoint_plys_byte_equal(tmp_path):
    """write_label_ply (default palette and a given one, labels past the
    palette) and write_superpoint_ply (over 1024 superpoints) write the
    bytes JAX writes."""
    rng = np.random.RandomState(0)
    xyz = rng.rand(500, 3) * 10
    labels = rng.randint(0, 13, 500)
    comp = rng.randint(0, 1500, 500)
    palette = jv.random_colors(5, seed=2)
    for name, jfn, tfn, args in (
            ("label", jv.write_label_ply, tv.write_label_ply,
             (xyz, labels)),
            ("label_palette", jv.write_label_ply, tv.write_label_ply,
             (xyz, labels, 13, palette)),
            ("superpoint", jv.write_superpoint_ply, tv.write_superpoint_ply,
             (xyz, comp, 4))):
        want, got = tmp_path / f"{name}_jax.ply", tmp_path / f"{name}.ply"
        jfn(str(want), *args)
        tfn(str(got), *args)
        assert got.read_bytes() == want.read_bytes(), name


def test_six_fold_cv_equals_jax(tmp_path):
    """The same PLY tree (Area_1 … Area_6, a few rooms each, one area
    empty) scores the same and logs the same line."""
    rng = np.random.RandomState(1)
    for area in (1, 2, 3, 5, 6):
        d = tmp_path / f"Area_{area}"
        d.mkdir()
        for room in range(area % 3 + 1):
            n = 200 + 50 * room
            gt = rng.randint(0, 13, n)
            pred = np.where(rng.rand(n) < 0.7, gt, rng.randint(0, 13, n))
            tv.write_prediction_ply(str(d / f"room_{room}.ply"),
                                    rng.rand(n, 3), pred, gt)
    logs = {"jax": [], "torch": []}
    want = jcv.six_fold_cv(str(tmp_path), log=logs["jax"].append)
    got = tcv.six_fold_cv(str(tmp_path), log=logs["torch"].append)
    assert got == want
    assert logs["torch"] == logs["jax"] and len(logs["jax"]) == 1


def test_metrics_writer_and_log_out_write_what_jax_writes(tmp_path, capsys):
    recs = [(0, dict(loss=np.float32(1.5), lr=0.01)),
            (7, dict(miou=np.float64(0.25), accuracy=1))]
    for name, mod in (("jax", jl), ("torch", tl)):
        w = mod.MetricsWriter(str(tmp_path / name / "metrics.jsonl"))
        for step, scalars in recs:
            w.write(step, **scalars)
        w.close()
        with open(tmp_path / f"{name}.log", "w") as f:
            mod.log_out("round 1 mIoU 0.5", f)
    assert (tmp_path / "torch" / "metrics.jsonl").read_text() == \
        (tmp_path / "jax" / "metrics.jsonl").read_text()
    assert json.loads((tmp_path / "torch" / "metrics.jsonl").read_text()
                      .splitlines()[1]) == {"step": 7, "miou": 0.25,
                                            "accuracy": 1.0}
    assert (tmp_path / "torch.log").read_text() == \
        (tmp_path / "jax.log").read_text()
    assert capsys.readouterr().out == "round 1 mIoU 0.5\n" * 2
    with tl.Timer() as timer:
        pass
    assert timer.seconds >= 0


def test_device_trace_writes_one_chrome_trace(tmp_path):
    """device_trace(log_dir) records the region with torch.profiler and
    writes one Chrome trace file under log_dir; None and "" are no-ops."""
    log_dir = tmp_path / "trace"
    with tl.device_trace(str(log_dir)):
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert tl.device_trace.last_path == str(log_dir / files[0])
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    for off in (None, ""):
        with tl.device_trace(off):
            pass
    assert os.listdir(log_dir) == files
    assert not [p for p in os.listdir(tmp_path) if p != "trace"]
