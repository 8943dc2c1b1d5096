"""The flagship twin (ssdr_al_torch/scripts/flagship.py) on the CPU, at 2
rooms x 3 000 points, 3 rounds, 2 train steps, 1 val step and 10 clicks a
round, in f32 on 512-point blocks: it writes the same round files,
snapshots and record lines as the same chain of cli.superpoint, cli.seed
and cli.al_loop calls typed by hand; its record parses with the reader
that parses the JAX package's results/record_round_flagship/; every round
record has its fields. Also: a Trainer made inside a function is freed
when the function returns, without a garbage collection (the first
optimizer's lazy import of torch._dynamo used to keep the frames on its
stack, and with them the first Trainer of a process and its eval graphs,
alive); the StepGraph's step records and the process's live graphs
(train/graphs.py::record_steps, live_graphs) through a CPU stand-in for a
capture. With trials: two trials of the default pool and one of the
sorted-block control share one partition and one seed round, each passes
its index to cli.al_loop as --t, reads no other trial's files, and the
control's pooled steps feed their blocks unshuffled. With seed trials
(arms all at s = 0, 1, set and model at s = 1, each followed by round 2):
each runs in its own copy of the one partition and leaves its files as
they were; all's s = 0 writes the shared seed round's state, snapshot
and log; s = 1 draws another seed set, other initial weights, dropout
and pipeline draws; set keeps s = 0's model streams and model s = 0's
seed set; a seed trial run alone writes what it wrote after the others;
a call without seed trials emits what it emitted before them."""

import contextlib
import gc
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from ssdr_al_torch.cli import al_loop
from ssdr_al_torch.scripts import flagship
from ssdr_al_torch.train import graphs
from ssdr_al_torch.train import trainer as tt

torch.set_num_threads(1)

SSDR = "t0-sb-clsbal-gcn_fps-WetSU-NAIL-0.9-1-1-0"
SMALL = ["--device", "cpu", "--rooms", "2", "--points", "3000", "--rounds",
         "3", "--train_steps", "2", "--val_steps", "1", "--clicks", "10",
         "--num_points", "512", "--compute_dtype", "float32"]
ROUND_FIELDS = ("round", "arm", "trial", "wall_s", "select_s",
                "phase_times", "stats", "train_s", "train_steps_s", "eval_s",
                "steps", "loss_first", "loss_last", "losses_finite", "miou",
                "oa", "k3", "live_graphs", "graph_pool_bytes")
CARD_FIELDS = ("warm_step_ms", "replays", "peak_bytes",
               "peak_reserved_bytes", "end_reserved_bytes",
               "end_allocated_bytes", "launches")


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """(records, out dir, work dir, live graphs) of the twin at the small
    size; live graphs: those of the process before the twin ran (stand-ins
    that other test files' captures left alive)."""
    root = tmp_path_factory.mktemp("flagship")
    work, out = str(root / "work"), str(root / "out")
    recs = []
    gc.collect()
    live = len(graphs.live_graphs())
    flagship.main(SMALL + ["--work", work, "--out", out], log=recs.append)
    return recs, out, work, live


SEED_TRIALS = ["--seed_trials", "0,1", "--seed_arms", "all,set,model",
               "--seed_rounds", "2"]
# the seed trials of SEED_TRIALS, in the order they run
SEED_PLAN = [("all", 0), ("all", 1), ("set", 1), ("model", 1)]


@pytest.fixture(scope="module")
def trials(tmp_path_factory):
    """(records, out dir, work dir, shuffled steps, inits) of the twin at
    the small size with trials 0 and 1 of the default pool, trial 0 of the
    sorted-block control and the seed trials SEED_TRIALS; shuffled steps:
    the pooled steps that shuffled their blocks; inits: at the
    Trainer.init_state of each seed round, (its init_seed, its dropout
    generator's seed, the digest of the weights drawn, the round's
    pipeline seed)."""
    from ssdr_al_torch.cli import seed as seed_cli

    root = tmp_path_factory.mktemp("trials")
    work, out = str(root / "work"), str(root / "out")
    recs, shuffled, inits, pipes = [], [], [], []
    fn, init, make_pipe = (tt.shuffle_blocks, tt.Trainer.init_state,
                           seed_cli.make_training_pipeline)

    def counted(*args, **kwargs):
        shuffled.append(1)
        return fn(*args, **kwargs)

    def drawn(self, *args, **kwargs):
        state = init(self, *args, **kwargs)
        # a seed round's (cli.al_loop restores a snapshot over its own)
        if len(pipes) > len(inits):
            inits.append((self.init_seed, self.dropout_gen.initial_seed(),
                          _digest(state), pipes[-1]))
        return state

    def pipeline(*args, **kwargs):
        pipes.append(kwargs["seed"])
        return make_pipe(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tt, "shuffle_blocks", counted)
        mp.setattr(tt.Trainer, "init_state", drawn)
        mp.setattr(seed_cli, "make_training_pipeline", pipeline)
        flagship.main(SMALL + ["--trials", "0,1", "--sorted_trials", "0",
                               "--work", work, "--out", out] + SEED_TRIALS,
                      log=recs.append)
    return recs, out, work, len(shuffled), inits


@pytest.fixture(scope="module")
def alone(tmp_path_factory):
    """(records, out dir, work dir) of the twin with trial 1 of the
    default pool and seed trial 1 of arm model, each alone."""
    root = tmp_path_factory.mktemp("alone")
    work, out = str(root / "work"), str(root / "out")
    recs = []
    flagship.main(SMALL + ["--trials", "1", "--seed_trials", "1",
                           "--seed_arms", "model", "--seed_rounds", "2", "--work", work, "--out",
                           out], log=recs.append)
    return recs, out, work


def _digest(state):
    import hashlib

    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _main_records(recs):
    """The records of the partition, the shared seed round and the trials
    (those of a call without seed trials)."""
    return [r for r in recs if r["event"] != "seed_trial"
            and not str(r.get("arm")).startswith("seed_")]


def by_hand(root):
    """The same run typed as three command lines, in `root`."""
    from ssdr_al_torch.cli import al_loop, seed, superpoint

    common = ["--device", "cpu", "--data_root", os.path.join(root, "data"),
              "--synthetic", "--synthetic_rooms", "2", "--synthetic_points",
              "3000", "--reg_strength", "0.03", "--num_points", "512",
              "--compute_dtype", "float32", "--train_steps", "2",
              "--max_epoch", "1", "--val_steps", "1"]
    superpoint.main(common)
    seed.main(common + ["--seed_percent", "0.01"])
    al_loop.main(common + [
        "--sampler", "T", "--t", "0", "--point_uncertainty_mode", "sb",
        "--classbal", "2", "--gcn_fps", "1", "--uncertainty_mode", "WetSU",
        "--oracle_mode", "NAIL", "--threshold", "0.9", "--min_size", "1",
        "--gcn_number", "1", "--gcn_top", "0", "--round", "2", "--rounds",
        "3", "--sp_batch_size", "10"])


def _files(top):
    out = {}
    for d, _, names in os.walk(top):
        for n in names:
            out[os.path.relpath(os.path.join(d, n), top)] = os.path.join(d,
                                                                         n)
    return out


def _record_lines(directory):
    """The record lines of each log, costTime values dropped (host
    clocks)."""
    return {n: [re.sub(r"costTime=[\d.]+", "costTime", line)
                for line in open(os.path.join(directory, n))]
            for n in sorted(os.listdir(directory)) if n.endswith(".txt")}


def test_twin_writes_what_the_cli_chain_writes(twin, tmp_path, monkeypatch):
    _, out, work, _ = twin
    monkeypatch.chdir(tmp_path)         # record_round/ goes to the cwd
    by_hand(str(tmp_path))
    reg = os.path.join("data", "S3DIS", "0.03")
    mine, theirs = (_files(os.path.join(r, reg)) for r in (work, tmp_path))
    assert sorted(mine) == sorted(theirs)
    rounds = [n for n in mine if re.search(rf"{SSDR}/round_\d+/", n)]
    assert {re.search(r"round_(\d+)", n).group(1) for n in rounds} == \
        {"2", "3"}
    for name in mine:
        if "/snapshots/" in name:
            a, b = (torch.load(p[name], weights_only=True)
                    for p in (mine, theirs))
            assert a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) for k in a), name
        else:
            with open(mine[name], "rb") as fa, open(theirs[name], "rb") as fb:
                assert fa.read() == fb.read(), name
    assert _record_lines(out) == _record_lines(
        str(tmp_path / "record_round"))
    assert sorted(os.listdir(out)) == sorted(
        ["S3DIS_5_seed_0.03.txt", f"S3DIS_5_{SSDR}_0.03.txt",
         "SUMMARY.md", "rounds.jsonl"])


def test_record_parses_as_the_jax_record(twin):
    _, out, _, _ = twin
    jax = flagship.read_record(flagship.JAX_RECORD)
    assert sorted(jax) == list(range(11))
    assert jax[0]["total_sp_num"] == 29379 and jax[0]["seeding"] == 293
    assert [jax[r]["best_miou"] for r in range(1, 11)] == [
        0.0762, 0.3988, 0.472, 0.6757, 0.6982, 0.7281, 0.7465, 0.767, 0.805,
        0.8234]
    assert all(jax[r]["gcn_sp_num"] == 150 for r in range(2, 11))
    port = flagship.read_record(out)
    assert sorted(port) == [0, 1, 2, 3]
    for r in (1, 2, 3):
        assert set(port[r]) == set(jax[r]), r
    assert all(port[r]["gcn_sp_num"] == 10 for r in (2, 3))


def test_round_records_have_their_fields(twin):
    recs, out, _, live = twin
    with open(os.path.join(out, "rounds.jsonl")) as f:
        assert [json.loads(line) for line in f] == json.loads(
            json.dumps(recs))
    kinds = [r["event"] for r in recs]
    assert kinds == ["flags", "partition", "round", "round", "round",
                     "done"]
    part = recs[1]
    assert len(part["rooms"]) == 2 and part["sp_count"] == sum(
        r["superpoints"] for r in part["rooms"])
    for room in part["rooms"]:
        assert {"knn_ms", "geof_ms", "cutpursuit_s", "superpoints"} <= \
            set(room)
    rounds = [r for r in recs if r["event"] == "round"]
    assert [r["round"] for r in rounds] == [1, 2, 3]
    for r in rounds:
        assert set(ROUND_FIELDS) <= set(r), r["round"]
        assert not set(CARD_FIELDS) & set(r)       # the card's only
        assert r["steps"] == 2 and r["losses_finite"]
        assert r["live_graphs"] == live            # no graphs on the CPU
    assert rounds[0]["phase_times"] == {} and rounds[0]["k3"] == {
        "calls": 0}
    for r in rounds[1:]:
        assert r["stats"]["gcn_sp_num"] == 10
        assert {"prediction_s", "diversity_s", "oracle_s"} <= set(
            r["phase_times"])
        assert r["k3"]["calls"] == 1 and 0 < r["k3"]["valid_share"] <= 1
    summary = open(os.path.join(out, "SUMMARY.md")).read()
    assert "| 10 | 0.8234 | - |" in summary and "Card: cpu." in summary
    assert recs[-1]["jax_miou"][-1] == 0.8234
    assert recs[-1]["curves"] == {"shuffled": {"0": [
        r["miou"] for r in rounds]}}
    assert recs[-1]["seed_shared"] and recs[-1]["seed_miou"] == \
        rounds[0]["miou"]
    assert [(r["arm"], r["trial"]) for r in rounds] == [
        (None, None), ("shuffled", 0), ("shuffled", 0)]


def _trial_files(work, trial):
    """{path: file} of trial `trial`'s AL state and snapshots."""
    reg = os.path.join(work, "data", "S3DIS", "0.03")
    sampler = SSDR.replace("t0", f"t{trial}", 1)
    return {os.path.join(top, k): v for top in ("sampling", "saver")
            for k, v in _files(os.path.join(reg, top, sampler)).items()}


def test_trials_share_the_partition_and_the_seed_round(trials):
    recs, out, work, _, _ = trials
    recs = _main_records(recs)
    kinds = [r["event"] for r in recs]
    assert kinds == ["flags", "partition"] + ["round"] * 7 + ["done"]
    rounds = [(r["arm"], r["trial"], r["round"]) for r in recs
              if r["event"] == "round"]
    assert rounds == [(None, None, 1)] + [
        (arm, t, r) for arm, t in (("shuffled", 0), ("shuffled", 1),
                                   ("sorted", 0)) for r in (2, 3)]
    done = recs[-1]
    assert done["seed_shared"]
    assert sorted(done["curves"]) == ["shuffled", "sorted"]
    assert sorted(done["curves"]["shuffled"]) == ["0", "1"]
    for arm in done["curves"].values():
        for curve in arm.values():
            assert len(curve) == 3 and curve[0] == done["seed_miou"]
    seed_log = "S3DIS_5_seed_0.03.txt"
    logs = [f"S3DIS_5_{SSDR.replace('t0', f't{t}', 1)}_0.03.txt"
            for t in (0, 1)]
    assert sorted(os.listdir(out)) == sorted(
        [seed_log] + logs + ["SUMMARY.md", "rounds.jsonl", "sorted",
                             "seed_all", "seed_set", "seed_model"])
    assert os.listdir(os.path.join(out, "sorted")) == logs[:1]
    reg = os.path.join("data", "S3DIS", "0.03")
    for where, samplers in ((work, ["seed", SSDR, SSDR.replace("t0", "t1")]),
                            (os.path.join(work, "sorted"), ["seed", SSDR])):
        for top in ("sampling", "saver"):
            assert sorted(os.listdir(os.path.join(where, reg, top))) == \
                sorted(samplers)
    # the control's copy holds the partition and the seed round as they
    # were: its superpoints and seed files equal the shared ones
    for sub in ("superpoint", os.path.join("sampling", "seed"),
                os.path.join("saver", "seed")):
        a, b = (_files(os.path.join(w, reg, sub))
                for w in (work, os.path.join(work, "sorted")))
        assert sorted(a) == sorted(b) and a
        for name in a:
            with open(a[name], "rb") as fa, open(b[name], "rb") as fb:
                assert fa.read() == fb.read(), name
    summary = open(os.path.join(out, "SUMMARY.md")).read()
    for col in ("shuffled t0", "shuffled t1", "sorted t0",
                "shuffled min / median / max", "sorted min / median / max"):
        assert col in summary
    assert summary.count("\n| 2 |") == 3        # three tables


def test_trials_pass_their_index_as_t():
    argv = flagship.command_lines(flagship.parser().parse_args(
        ["--device", "cpu"]))["al_loop"]
    for t in (0, 1, 7):
        args = al_loop.parser().parse_args(flagship.trial_flags(argv, t))
        assert args.t == t
        assert al_loop.build_sampler_args(args) == [f"t{t}"] + \
            flagship.SSDR_ARGS[1:]
    assert flagship.parse_trials("0,1,2") == [0, 1, 2]
    assert flagship.parse_trials("") == []
    with pytest.raises(ValueError):
        flagship.parse_trials("1,1")


def test_a_trial_reads_no_other_trials_files(trials, alone):
    """Trial 1 run alone writes what trial 1 wrote after trial 0: the
    same state files, snapshots and record lines."""
    _, out, work, _, _ = trials
    _, alone_out, alone_work = alone
    mine, theirs = _trial_files(work, 1), _trial_files(alone_work, 1)
    assert sorted(mine) == sorted(theirs) and mine
    for name in mine:
        if "snapshots" in name:
            a, b = (torch.load(p[name], weights_only=True)
                    for p in (mine, theirs))
            assert all(torch.equal(a[k], b[k]) for k in a), name
        else:
            with open(mine[name], "rb") as fa, open(theirs[name], "rb") as fb:
                assert fa.read() == fb.read(), name
    log = f"S3DIS_5_{SSDR.replace('t0', 't1')}_0.03.txt"
    assert _record_lines(out)[log] == _record_lines(alone_out)[log]


def test_the_sorted_control_feeds_its_blocks_unshuffled(trials):
    """Only the default pool's steps shuffle (2 trials x 2 rounds x 2
    steps, and the seed trials' rounds; the seed round trains on the host
    pipeline); the control's
    first step, from the same snapshot and the same draws as trial 0's,
    takes another loss."""
    recs, _, _, shuffled, _ = trials
    # and the seed trials' round 2 (4 seed trials x 2 steps)
    assert shuffled == 2 * 2 * 2 + len(SEED_PLAN) * 2
    first = {(r["arm"], r["trial"]): r["loss_first"] for r in recs
             if r["event"] == "round" and r["round"] == 2}
    assert first[("sorted", 0)] != first[("shuffled", 0)]


def _seed_run(recs, arm, s):
    return next(r for r in recs if r["event"] == "seed_trial"
                and (r["arm"], r["seed_trial"]) == (arm, s))


def _seed_rounds(recs, arm, s):
    return {r["round"]: r for r in recs if r["event"] == "round"
            and (r["arm"], r.get("seed_trial")) == (f"seed_{arm}", s)}


def test_seed_trials_run_in_copies_of_the_partition(trials):
    recs, out, work, _, _ = trials
    assert [(r["arm"], r["seed_trial"]) for r in recs
            if r["event"] == "seed_trial"] == SEED_PLAN
    rounds = [(r["arm"], r["seed_trial"], r["trial"], r["round"])
              for r in recs if r["event"] == "round"
              and str(r["arm"]).startswith("seed_")]
    assert rounds == [(f"seed_{a}", s, t, r) for a, s in SEED_PLAN
                      for t, r in ((None, 1), (0, 2))]
    for a, s in SEED_PLAN:
        run = _seed_run(recs, a, s)
        assert run["partition_shared"]
        assert (run["set_seed"], run["model_seed"]) == \
            flagship.SEED_ARMS[a](s)
        by = _seed_rounds(recs, a, s)
        st = by[1]["stats"]
        for r in by.values():
            assert (r["seed_regions"], r["seed_points"]) == (
                st["sp_num"] + st["sub_num"], st["p_num"] + st["sub_p_num"])
            assert set(ROUND_FIELDS) <= set(r) and r["losses_finite"]
        assert by[2]["stats"]["gcn_sp_num"] == 10
        assert sorted(os.listdir(os.path.join(out, f"seed_{a}", f"s{s}"))) \
            == ["S3DIS_5_seed_0.03.txt", f"S3DIS_5_{SSDR}_0.03.txt"]
    # every copy is gone once read
    assert sorted(os.listdir(work)) == ["data", "record_round", "sorted"]
    done = recs[-1]
    assert [(row["arm"], row["seed_trial"]) for row in
            done["seed_trials"]] == SEED_PLAN
    for row in done["seed_trials"]:
        assert row["partition_shared"] and list(row["rounds"]) == ["2"]
        assert row["seed"]["miou"] == round(_seed_rounds(
            recs, row["arm"], row["seed_trial"])[1]["miou"], 4)
    summary = open(os.path.join(out, "SUMMARY.md")).read()
    for text in ("## Seed trials", "| JAX | - | 0.0762 | 0.2872 | 293 |",
                 "| all min / median / max |", "| set min / median / max |",
                 "| model min / median / max |",
                 "JAX's figure within arm all's [min, max] over its 2"):
        assert text in summary, text


def test_seed_trial_zero_is_the_seed_round(trials):
    """Arm all's s = 0 writes the shared seed round's state, snapshot and
    log byte for byte (the shared seed round is the plain cli.seed call's:
    test_twin_writes_what_the_cli_chain_writes), and its round 2 is trial
    0's."""
    recs, out, work, _, inits = trials
    run = _seed_run(recs, "all", 0)
    shared = {d: flagship.file_digests(os.path.join(work, d))
              for d in run["seed_files"]}
    assert run["seed_files"] == shared and all(shared.values())
    assert recs[-1]["seed_zero_shared"]
    assert inits[0] == inits[1] == (0, 0, inits[0][2], 0)
    mine = _record_lines(os.path.join(out, "seed_all", "s0"))
    main = _record_lines(out)
    seed_log, al_log = "S3DIS_5_seed_0.03.txt", f"S3DIS_5_{SSDR}_0.03.txt"
    assert mine[seed_log] == main[seed_log]
    assert mine[al_log] == [line for line in main[al_log]
                            if not line.startswith("round= 3")]
    seed, t0 = _seed_rounds(recs, "all", 0), {
        r["round"]: r for r in recs if r["event"] == "round"
        and (r["arm"], r["trial"]) == ("shuffled", 0)}
    main1 = next(r for r in recs if r["event"] == "round"
                 and r["arm"] is None)
    for key in ("miou", "oa", "stats", "loss_first", "loss_last"):
        assert seed[1][key] == main1[key], key
        assert seed[2][key] == t0[2][key], key


def test_seed_trials_draw_their_arms_streams(trials):
    """inits in order: the shared seed round, all 0, all 1, set 1, model
    1. All 1 draws other weights, dropout and pipeline draws and another
    seed set; set 1 keeps s = 0's model streams and takes all 1's seed
    set; model 1 keeps s = 0's seed set and takes all 1's model
    streams."""
    recs, _, _, _, inits = trials
    assert len(inits) == 1 + len(SEED_PLAN)
    _, all0, all1, set1, model1 = inits
    assert all1[:2] == (1, 1) and all1[3] == 1 and all1[2] != all0[2]
    assert set1 == all0 and model1 == all1

    def seed_set(arm, s):
        return next(v for d, v in _seed_run(recs, arm, s)[
            "seed_files"].items() if d.endswith(os.path.join("sampling",
                                                             "seed")))

    def snap(arm, s):
        return next(v for d, v in _seed_run(recs, arm, s)[
            "seed_files"].items() if d.endswith(os.path.join("saver",
                                                             "seed")))

    assert seed_set("all", 1) != seed_set("all", 0)
    assert seed_set("set", 1) == seed_set("all", 1)
    assert seed_set("model", 1) == seed_set("all", 0)
    snaps = [snap(a, s) for a, s in SEED_PLAN]
    assert len(set(map(json.dumps, snaps))) == len(snaps)
    regions = {(a, s): _seed_rounds(recs, a, s)[1]["seed_points"]
               for a, s in SEED_PLAN}
    assert regions[("set", 1)] == regions[("all", 1)]
    assert regions[("model", 1)] == regions[("all", 0)]


def test_a_seed_trial_reads_no_other_seed_trials_files(trials, alone):
    """Model's s = 1 run alone writes what it wrote after all 0, all 1
    and set 1: the same seed files, log lines and round records."""
    recs, out, _, _, _ = trials
    arecs, aout, awork = alone
    assert _seed_run(arecs, "model", 1)["seed_files"] == _seed_run(
        recs, "model", 1)["seed_files"]
    where = os.path.join("seed_model", "s1")
    assert _record_lines(os.path.join(out, where)) == _record_lines(
        os.path.join(aout, where))
    mine, theirs = (_seed_rounds(r, "model", 1) for r in (recs, arecs))
    for r in (1, 2):
        for key in ("miou", "oa", "stats", "loss_first", "loss_last"):
            assert mine[r][key] == theirs[r][key], (r, key)
    assert sorted(os.listdir(awork)) == ["data", "record_round"]


def test_a_call_without_seed_trials_emits_what_it_did(twin):
    recs, out, work, _ = twin
    assert set(recs[-1]) == {"event", "wall_s", "seed_shared", "seed_miou",
                             "curves", "jax_miou"}
    assert not any(r["event"] == "seed_trial" or {
        "seed_trial", "seed_regions", "seed_points"} & set(r) for r in recs)
    assert "## Seed trials" not in open(os.path.join(out,
                                                     "SUMMARY.md")).read()
    assert sorted(os.listdir(work)) == ["data", "record_round"]
    parse = flagship.parser().parse_args
    assert flagship.seed_trial_plan(parse([])) == []
    plan = flagship.seed_trial_plan(parse([
        "--seed_trials", "0,1,2,3,4,5,6,7", "--seed_arms", "all,set,model"]))
    assert plan == [("all", s) for s in range(8)] + [
        (a, s) for a in ("set", "model") for s in (1, 2, 3)]
    with pytest.raises(ValueError):
        flagship.seed_trial_plan(parse(["--seed_trials", "1",
                                        "--seed_arms", "all,seeds"]))


def test_cpu_only_when_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError):
        flagship.main(["--rounds", "1"], log=lambda r: None)


def test_a_trainer_is_freed_when_its_function_returns():
    """In a fresh process, with garbage collection off: the first Trainer
    of the process, made inside a function, is gone once the function
    returns."""
    code = """
import gc, weakref
gc.disable()
import numpy as np, torch
from ssdr_al_torch.config import ConfigS3DIS
from ssdr_al_torch.train.trainer import Trainer

def run():
    t = Trainer(ConfigS3DIS, "S3DIS", save_dir="unused", device="cpu",
                weights=np.ones(13, np.float32))
    return weakref.ref(t), weakref.ref(t.eval_step)

refs = run()
print(all(r() is None for r in refs))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True"


class _FakeEvent:
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        _FakeEvent.clock += 1.0
        self.t = _FakeEvent.clock

    def elapsed_time(self, end):
        return end.t - self.t


def test_step_records_and_live_graphs(monkeypatch):
    """A StepGraph on a CPU stand-in (the capture runs nothing; a replay
    runs the step): record_steps names its calls eager, capture and
    replay in turn with their events; its Graph is live with its pool's
    bytes while the StepGraph lives, and gone after."""

    class Replay:
        def __init__(self, step):
            self.step = step

        def replay(self):
            self.step()

    def capture(step, generators, device):
        return graphs.Graph(Replay(step), {}), None

    monkeypatch.setattr(graphs, "warm", lambda step, device: step())
    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    reserved = iter([100, 164])
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda *a: next(reserved))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    calls = []
    sg = graphs.StepGraph(lambda: calls.append(1), (), "cpu")
    before = len(graphs.live_graphs())
    sg()                                        # outside: not recorded
    with graphs.record_steps() as steps:
        for _ in range(5):
            sg()
    sg()
    times = graphs.step_ms(steps)
    assert [k for k, _ in times] == ["eager", "eager", "capture", "replay",
                                     "replay"]
    assert all(ms == 1.0 for _, ms in times)
    assert len(calls) == 3 + 4                  # 3 eager steps, 4 replays
    assert sg.graph.pool_bytes == 64 and sg.stats()["capture_bytes"] == 64
    assert len(graphs.live_graphs()) == before + 1
    del sg
    assert len(graphs.live_graphs()) == before


def test_warm_steps_share_one_side_stream(monkeypatch):
    """Every warm step on a device runs on one side stream, made at the
    first (cuBLAS keeps a workspace for each stream it has run on)."""

    class Stream:
        made = []

        def __init__(self, device):
            self.device = device
            self.waits = []
            Stream.made.append(self)

        def wait_stream(self, other):
            self.waits.append(other)

    on = []

    @contextlib.contextmanager
    def stream(s):
        on.append(s)
        yield

    current = {d: Stream(d) for d in ("cuda:0", "cuda:1")}
    Stream.made.clear()
    monkeypatch.setattr(graphs, "_SIDE_STREAMS", {})
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: current[d])
    monkeypatch.setattr(torch.cuda, "stream", stream)
    outs = [graphs.warm(lambda i=i: i, d)
            for i, d in enumerate(["cuda:0", "cuda:0", "cuda:1", "cuda:0"])]
    assert outs == [0, 1, 2, 3]
    assert [s.device for s in Stream.made] == ["cuda:0", "cuda:1"]
    assert on == [Stream.made[0]] * 2 + [Stream.made[1], Stream.made[0]]
    assert current["cuda:0"].waits == [Stream.made[0]] * 3
