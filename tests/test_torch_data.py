"""ssdr_al_torch.config and ssdr_al_torch.data against the JAX package's
config and data modules: same fields, and the same arrays from the same
seeds."""

import dataclasses

import numpy as np
import pytest
import torch

from ssdr_al_tpu.config import ConfigS3DIS as JConfigS3DIS
from ssdr_al_tpu.data import synthetic as j_syn
from ssdr_al_tpu.data.dataset import SamplingPipeline as JSamplingPipeline
from ssdr_al_torch import data as t_data
from ssdr_al_torch.config import ConfigS3DIS

torch.set_num_threads(1)


def test_config_fields_match_jax():
    for f in dataclasses.fields(ConfigS3DIS):
        assert getattr(ConfigS3DIS, f.name) == getattr(JConfigS3DIS, f.name), \
            f.name


@pytest.mark.parametrize("hard", [False, True])
def test_make_dataset_matches_jax(hard):
    want = j_syn.make_dataset(num_train=2, num_val=1, num_points=4000,
                              seed=3, hard=hard)
    got = t_data.make_dataset(num_train=2, num_val=1, num_points=4000,
                              seed=3, hard=hard)
    for gs, ws in zip(got, want):
        assert [c.name for c in gs] == [c.name for c in ws]
        for g, w in zip(gs, ws):
            for field in ("xyz", "colors", "labels"):
                a, b = getattr(g, field), getattr(w, field)
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b)
            assert g.num_points == w.num_points


@pytest.mark.parametrize("target_sp", [16, 300])
def test_grid_superpoints_matches_jax(target_sp):
    xyz = (np.random.RandomState(4).rand(5000, 3) * [6, 6, 3]).astype(
        np.float32)
    tc, ti = t_data.grid_superpoints(xyz, target_sp)
    jc, ji = j_syn.grid_superpoints(xyz, target_sp)
    np.testing.assert_array_equal(ti, ji)
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)


def test_cloud_chunks_match_jax():
    """Same chunks, padding and centring: 3 chunks of 1024, the last one
    padded (valid 952)."""
    cfg = dataclasses.replace(JConfigS3DIS, num_points=1024)
    (cloud,), _ = t_data.make_dataset(num_train=1, num_val=0,
                                      num_points=3000, seed=5)
    got = list(t_data.SamplingPipeline([cloud], cfg, seed=6)
               .cloud_chunks(cloud))
    want = list(JSamplingPipeline([cloud], cfg, seed=6).cloud_chunks(cloud))
    assert len(got) == len(want) == 3
    for (gb, gi, gv), (wb, wi, wv) in zip(got, want):
        assert gv == wv
        np.testing.assert_array_equal(gi, wi)
        assert gb.keys() == wb.keys()
        for k in gb:
            assert gb[k].dtype == wb[k].dtype
            np.testing.assert_array_equal(gb[k], wb[k])
    assert got[-1][2] < 1024
