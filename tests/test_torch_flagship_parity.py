"""One snapshot through both selections: the flagship's AL rounds 2 and 3
(the full SSDR TSampler t0-sb-clsbal-gcn_fps-WetSU-NAIL-0.9-1-1-0) on
ssdr_al_torch and on ssdr_al_tpu from the same trained model, on the
CPU. This separates "the port selects differently given the same model"
from "the port trains a different model".

The workload is the flagship's, cut in size: the CLI's hard synthetic
rooms (--synthetic), the port's cut-pursuit partition at reg_strength
0.03 (cli.superpoint, written once and copied to the JAX package's
directory), a seed round of SEED_PERCENT of the superpoints and a model
the port trains on it for TRAIN_STEPS f32 steps, so that it is no longer
random. Both packages, in f32 and in bf16, then select round 2 from that
snapshot and round 3 from the same snapshot and one round-2 state (the
port's f32 round_2/ files copied to every other side), so that round 3
holds the selection with a carried clsbal class list against the same
input.
GCN-FPS has no weights (it propagates the region features over the
chamfer graph), and the selection forward runs in eval mode, so no
random stream enters either side beyond the samplers' numpy seeds.

Tolerances (f32): the picked superpoints overlap by at least
MIN_OVERLAP, and each RoundStats count is within STATS_REL of JAX's
(relative, at least STATS_ABS). bf16: the port's bf16 round against JAX's
bf16 round is held to JAX's own bf16 round against its f32 round, in the
same test: its pick overlap at least JAX's own less (1 − MIN_OVERLAP),
and its labelled points (p_num + sub_p_num) within JAX's own gap plus
STATS_REL of JAX's count.

The same comparison at the flagship's own partition (6 rooms × 150 000
points, reg 0.03, the full-width model, a snapshot the port trained on
the card) runs as a `slow` case, or as

    PYTHONPATH=. JAX_PLATFORMS=cpu python \
        tests/test_torch_flagship_parity.py --snapshot DIR [--write]

where DIR holds the twin's work directory's data/S3DIS/0.03/{superpoint,
sampling/seed, saver/seed} (scripts/flagship.py); --write puts the
result into results/record_round_flagship_torch/SUMMARY.md."""

import argparse
import dataclasses
import json
import os
import pickle
import shutil
import time

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdr_al_tpu.active import samplers as j_samplers
from ssdr_al_tpu.active import state as j_state
from ssdr_al_tpu.config import ConfigS3DIS as JConfigS3DIS
from ssdr_al_tpu.models import randlanet as jr
from ssdr_al_tpu.train import trainer as j_trainer
from ssdr_al_torch.active import samplers as t_samplers
from ssdr_al_torch.active import state as t_state
from ssdr_al_torch.cli import superpoint
from ssdr_al_torch.cli.common import (
    make_training_pipeline,
    pseudo_gt_for_round,
    setup_experiment,
)
from ssdr_al_torch.config import ConfigS3DIS
from ssdr_al_torch.models import randlanet as tr
from ssdr_al_torch.train.trainer import Trainer, make_eval_step

from torch_parity import flax_from_params, random_flax_variables

torch.set_num_threads(1)

SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]
REG = 0.03
# the small workload: 2 hard rooms of 6 000 points (~890 superpoints), a
# narrow 3-layer model on 1024-point blocks, 5 % of the superpoints
# seeded, 64 steps (the NAIL split then runs), 20 clicks a round
ROOMS, POINTS = 2, 6000
SMALL_MODEL = dict(num_layers=3, d_out=(8, 16, 32),
                   sub_sampling_ratio=(4, 4, 2), num_points=1024)
SEED_PERCENT, TRAIN_STEPS, CLICKS = 0.05, 64, 20
MIN_OVERLAP = 0.9
STATS_REL, STATS_ABS = 0.1, 2
STAT_FIELDS = ("sp_num", "p_num", "sub_num", "sub_p_num", "ignore_sp_num",
               "split_sp_num", "gcn_sp_num", "gcn_unlabel_num")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@flax.struct.dataclass
class FlaxState:
    """The model state JAX's eval step reads (a TrainState's variables)."""
    params: dict
    batch_stats: dict


def cli_args(root, rooms, points, num_points, steps, dtype="float32"):
    """cli.superpoint's parsed flags for the synthetic hard rooms in
    root/data."""
    return superpoint.parser().parse_args([
        "--device", "cpu", "--dataset", "S3DIS", "--data_root",
        os.path.join(root, "data"), "--synthetic", "--synthetic_rooms",
        str(rooms), "--synthetic_points", str(points), "--reg_strength",
        str(REG), "--num_points", str(num_points), "--compute_dtype", dtype,
        "--train_steps", str(steps), "--max_epoch", "1", "--val_steps", "1"])


def seed_and_train(exp, cfg, sp_num, percent, steps):
    """The seed round's labels (SeedSampler, `percent` of the superpoints)
    and the port's model trained on them for `steps` f32 steps from the
    flax initializers (Trainer.train_round on the host pipeline): its
    state_dict."""
    state = t_state.ALState(exp.data_path, ["seed"])
    t_samplers.SeedSampler(state, exp.train_clouds, sp_num).sampling(
        max(1, int(sp_num * percent)), 0, t_state.RoundStats())
    exp = dataclasses.replace(exp, cfg=dataclasses.replace(
        cfg, train_steps=steps, max_epoch=1))
    pipe = make_training_pipeline(exp, pseudo_gt=pseudo_gt_for_round(
        state, state.round_dir(1), exp.train_clouds))
    trainer = Trainer(exp.cfg, "S3DIS", save_dir=os.path.join(
        exp.data_path, "saver", "seed", "snapshots"), device="cpu",
        weights=np.ones(exp.cfg.num_classes, np.float32))
    trainer.init_state()
    trainer.train_round(1, lambda epoch: pipe.batches(steps,
                                                      exp.cfg.batch_size))
    return {k: v.clone() for k, v in trainer.state.items()}


def jax_config(cfg):
    """The JAX package's Config with the port Config's values."""
    names = {f.name for f in dataclasses.fields(JConfigS3DIS)}
    return dataclasses.replace(JConfigS3DIS, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name in names})


def _unlabeled(directory):
    with open(os.path.join(directory, "total.pkl"), "rb") as f:
        return pickle.load(f)["unlabeled"]


def _picks(work, round_num):
    """{(cloud, superpoint)} labelled in round `round_num`."""
    sel = os.path.join(work, "sampling", "-".join(SSDR_ARGS))
    before = (_unlabeled(os.path.join(work, "sampling", "seed", "round_1"))
              if round_num == 2 else
              _unlabeled(os.path.join(sel, f"round_{round_num - 1}")))
    after = _unlabeled(os.path.join(sel, f"round_{round_num}"))
    return {(n, int(s)) for n, v in before.items()
            for s in set(v) - set(after.get(n, []))}


class Side:
    """One package's TSampler over a copy of the shared partition and
    seed round, with the snapshot's model in `dtype`."""

    def __init__(self, pkg, data_path, work, clouds, cfg, sd, sp_num, dtype):
        shutil.rmtree(work, ignore_errors=True)
        for sub in ("superpoint", os.path.join("sampling", "seed")):
            shutil.copytree(os.path.join(data_path, sub),
                            os.path.join(work, sub))
        cfg = dataclasses.replace(cfg, compute_dtype=dtype)
        self.pkg, self.work = pkg, work
        if pkg == "torch":
            model = tr.RandLANet(cfg)
            self.eval_step = make_eval_step(model, cfg, "xla", True,
                                            device="cpu")
            self.model_state = sd
            self.sampler = t_samplers.TSampler(
                t_state.ALState(work, SSDR_ARGS), clouds, cfg,
                t_samplers.TSamplerArgs(), sp_num, device="cpu")
        else:
            cfg = jax_config(cfg)
            v = flax_from_params(sd)
            self.eval_step = j_trainer.make_eval_step(jr.RandLANet(cfg), cfg,
                                                      "xla", True)
            self.model_state = FlaxState(
                params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                   v["batch_stats"]))
            self.sampler = j_samplers.TSampler(
                j_state.ALState(work, SSDR_ARGS), clouds, cfg,
                j_samplers.TSamplerArgs(), sp_num)
        self.picks, self.stats = {}, {}

    def round(self, round_num, clicks, state_from=None):
        """Select round `round_num`; with `state_from`, round_<n-1>/ is
        first replaced by that side's."""
        if state_from is not None:
            prev = os.path.join("sampling", "-".join(SSDR_ARGS),
                                f"round_{round_num - 1}")
            shutil.rmtree(os.path.join(self.work, prev))
            shutil.copytree(os.path.join(state_from.work, prev),
                            os.path.join(self.work, prev))
        st = (t_state if self.pkg == "torch" else j_state).RoundStats()
        t0 = time.perf_counter()
        self.sampler.sampling(self.eval_step, self.model_state, clicks,
                              round_num - 1, st)
        self.stats[round_num] = dict(
            st.as_dict(), select_s=time.perf_counter() - t0,
            phase_s=dict(getattr(self.sampler, "phase_times", {})))
        self.picks[round_num] = _picks(self.work, round_num)


def overlap(a, b):
    return len(a & b) / max(len(a), len(b), 1)


def points(stats):
    return stats["p_num"] + stats["sub_p_num"]


def compare(data_path, clouds, cfg, sd, sp_num, clicks, scratch,
            log=print):
    """Rounds 2 and 3 on both packages in f32 and in bf16 from one
    snapshot: {"torch" | "jax": {dtype: Side}}. Every side selects round
    2 from the seed round and round 3 from the port's f32 round-2 state,
    so that JAX's bf16 round against its f32 round, from the same input,
    is JAX's own bf16 gap."""
    made = {pkg: {dt: Side(pkg, data_path,
                           os.path.join(scratch, f"{pkg}-{dt}"), clouds,
                           cfg, sd, sp_num, dt)
                  for dt in ("float32", "bfloat16")}
            for pkg in ("torch", "jax")}
    ref = made["torch"]["float32"]
    for r in (2, 3):
        for pkg in made:
            for side in made[pkg].values():
                side.round(r, clicks, None if r == 2 or side is ref else ref)
        log(json.dumps({"round": r, **{
            f"{pkg}_{dt}": side.stats[r] for pkg in made
            for dt, side in made[pkg].items()}, **overlaps(made, r)}))
    return made


def overlaps(made, r):
    """The pick overlaps of round r that check() reads."""
    t, j = made["torch"], made["jax"]
    return {"overlap_f32": overlap(t["float32"].picks[r],
                                   j["float32"].picks[r]),
            "overlap_bf16": overlap(t["bfloat16"].picks[r],
                                    j["bfloat16"].picks[r]),
            "overlap_jax_bf16_f32": overlap(j["bfloat16"].picks[r],
                                            j["float32"].picks[r])}


def stats_within(got, want):
    """The RoundStats fields of `got` outside STATS_REL (at least
    STATS_ABS) of `want`'s."""
    return {f: (got[f], want[f]) for f in STAT_FIELDS
            if abs(got[f] - want[f]) > max(STATS_ABS, STATS_REL * want[f])}


def check(made, dtype):
    """The tolerances of the module docstring on compare()'s result, in
    `dtype`."""
    t, j, jf = (made["torch"][dtype], made["jax"][dtype],
                made["jax"]["float32"])
    for r in (2, 3):
        assert t.picks[r] and t.stats[r]["gcn_sp_num"] == \
            j.stats[r]["gcn_sp_num"], r
        ov = overlaps(made, r)
        if dtype == "float32":
            assert ov["overlap_f32"] >= MIN_OVERLAP, (r, ov)
            assert not stats_within(t.stats[r], j.stats[r]), (
                r, stats_within(t.stats[r], j.stats[r]))
            continue
        assert ov["overlap_bf16"] >= ov["overlap_jax_bf16_f32"] - (
            1 - MIN_OVERLAP), (r, ov)
        own_gap = abs(points(j.stats[r]) - points(jf.stats[r]))
        gap = abs(points(t.stats[r]) - points(j.stats[r]))
        assert gap <= own_gap + STATS_REL * points(j.stats[r]), (
            r, gap, own_gap)


# ------------------------------------------------------------- the tests ---


def test_flax_from_params_round_trips():
    """flax variables → params_from_flax → flax_from_params gives the same
    tree, leaf for leaf, and the JAX model applies it; and a port
    state_dict → flax_from_params → params_from_flax gives it back."""
    cfg = jax_config(dataclasses.replace(ConfigS3DIS, **SMALL_MODEL))
    rng = np.random.RandomState(0)
    xyz = (rng.rand(1, 512, 3) * 4).astype(np.float32)
    feats = np.concatenate([xyz, rng.rand(1, 512, 3).astype(np.float32)], -1)
    model = jr.RandLANet(cfg)
    pyr = jr.build_pyramid(jnp.asarray(xyz), cfg, engine="xla")
    v = random_flax_variables(jax.jit(lambda f: model.init(
        {"params": jax.random.PRNGKey(0)}, f, pyr, False))(
            jnp.asarray(feats)), seed=1)
    sd = tr.params_from_flax(v["params"], v["batch_stats"])
    back = flax_from_params(sd)
    flat = jax.tree_util.tree_flatten_with_path
    want, got = flat(v)[0], flat(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    a, b = (np.asarray(model.apply(x, jnp.asarray(feats), pyr, False)[0])
            for x in (v, back))
    np.testing.assert_array_equal(a, b)
    again = tr.params_from_flax(back["params"], back["batch_stats"])
    assert again.keys() == sd.keys()
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    m = tr.RandLANet(cfg)
    m.load_state_dict(again)                      # strict


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """compare() at the small size, f32 and bf16."""
    root = str(tmp_path_factory.mktemp("flagship_parity"))
    args = cli_args(root, ROOMS, POINTS, SMALL_MODEL["num_points"],
                    TRAIN_STEPS)
    total, _ = superpoint.run_superpoint(args)
    exp = setup_experiment(args)
    cfg = dataclasses.replace(exp.cfg, **SMALL_MODEL)
    sd = seed_and_train(exp, cfg, total["sp_num"], SEED_PERCENT, TRAIN_STEPS)
    return compare(exp.data_path, exp.train_clouds, cfg, sd,
                   total["sp_num"], CLICKS, os.path.join(root, "sides"))


def test_rounds_2_and_3_match_jax_in_f32(small):
    check(small, "float32")


def test_rounds_2_and_3_in_bf16_within_jax_own_gap(small):
    check(small, "bfloat16")


# ------------------------------------------------ the flagship's own size ---

FLAG_ROOMS, FLAG_POINTS, FLAG_BLOCK, FLAG_CLICKS = 6, 150_000, 40960, 150
SUMMARY = os.path.join(REPO, "results", "record_round_flagship_torch",
                       "SUMMARY.md")
SECTION = "## One snapshot through both selections"


def flagship_scale(snapshot, scratch, log=print):
    """compare() at the flagship's own partition: the rooms made anew by
    the CLI's seeded generator, and the port's partition, seed round and
    snap-1 from `snapshot` (a directory holding the twin's
    data/S3DIS/0.03/{superpoint, sampling/seed, saver/seed}); the
    flagship's full-width model and 150 clicks a round."""
    root = os.path.join(scratch, "flagship")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(snapshot, "data"),
                    os.path.join(root, "data"))
    exp = setup_experiment(cli_args(root, FLAG_ROOMS, FLAG_POINTS,
                                    FLAG_BLOCK, 500, "bfloat16"))
    total = t_state.ALState(exp.data_path, ["seed"]).load_registry()
    if total["point_num"] != sum(c.num_points for c in exp.train_clouds):
        raise ValueError("the snapshot's partition is of other rooms")
    sd = torch.load(os.path.join(exp.data_path, "saver", "seed",
                                 "snapshots", "snap-1"), weights_only=True)
    return compare(exp.data_path, exp.train_clouds, exp.cfg, sd,
                   total["sp_num"], FLAG_CLICKS, os.path.join(root, "sides"),
                   log)


def section(made, command):
    """The markdown of compare()'s result for SUMMARY.md."""
    cols = [(pkg, dt) for dt in ("float32", "bfloat16")
            for pkg in ("torch", "jax")]
    lines = [SECTION, "",
             "The port's snap-1 of this run's seed round, at this run's "
             "partition, through the port's and the JAX package's full "
             "SSDR selection on the CPU (exact `xla` KNN on both sides, "
             "dropout off): round 2 from the seed round, round 3 from the "
             "port's f32 round-2 state on every side "
             "(tests/test_torch_flagship_parity.py).", "",
             f"Command: `{command}`.", "",
             "| round | field | " + " | ".join(
                 f"{'port' if p == 'torch' else 'JAX'} {d}"
                 for p, d in cols) + " |",
             "|" + " --- |" * (2 + len(cols))]
    for r in (2, 3):
        for f in STAT_FIELDS + ("select_s",):
            lines.append(f"| {r} | {f} | " + " | ".join(
                f"{made[p][d].stats[r][f]:.1f}" if f == "select_s" else
                str(made[p][d].stats[r][f]) for p, d in cols) + " |")
        ov = overlaps(made, r)
        lines.append(
            f"| {r} | pick overlap | port f32 / JAX f32 "
            f"{ov['overlap_f32']:.3f} | port bf16 / JAX bf16 "
            f"{ov['overlap_bf16']:.3f} | JAX bf16 / JAX f32 "
            f"{ov['overlap_jax_bf16_f32']:.3f} | |")
    return "\n".join(lines) + "\n"


def write_section(path, text):
    """Put `text` at the end of `path`, in place of an earlier copy."""
    with open(path) as f:
        old = f.read()
    keep = old.split(SECTION)[0].rstrip("\n")
    with open(path, "w") as f:
        f.write(keep + "\n\n" + text)


@pytest.mark.slow
def test_flagship_partition_rounds_match_jax(tmp_path):
    """compare() at the flagship's partition from the snapshot directory
    in SSDR_FLAGSHIP_SNAPSHOT, held to the same tolerances."""
    snapshot = os.environ.get("SSDR_FLAGSHIP_SNAPSHOT")
    if not snapshot:
        pytest.skip("SSDR_FLAGSHIP_SNAPSHOT names no snapshot directory")
    made = flagship_scale(snapshot, str(tmp_path))
    check(made, "float32")
    check(made, "bfloat16")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--snapshot", required=True,
                    help="directory holding the twin's data/S3DIS/0.03/"
                         "{superpoint, sampling/seed, saver/seed}")
    ap.add_argument("--scratch", default=os.path.join(REPO, "build",
                                                      "flagship_parity"))
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--write", action="store_true",
                    help="put the result into " + SUMMARY)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    made = flagship_scale(args.snapshot, args.scratch)
    text = section(made, "PYTHONPATH=. JAX_PLATFORMS=cpu python "
                   "tests/test_torch_flagship_parity.py --snapshot <the "
                   "twin's work directory> --write")
    print(text)
    if args.write:
        write_section(SUMMARY, text)
    for dtype in ("float32", "bfloat16"):
        check(made, dtype)


if __name__ == "__main__":
    main()
