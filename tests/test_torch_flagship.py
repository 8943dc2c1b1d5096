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
capture."""

import contextlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from ssdr_al_torch.scripts import flagship
from ssdr_al_torch.train import graphs

torch.set_num_threads(1)

SSDR = "t0-sb-clsbal-gcn_fps-WetSU-NAIL-0.9-1-1-0"
SMALL = ["--device", "cpu", "--rooms", "2", "--points", "3000", "--rounds",
         "3", "--train_steps", "2", "--val_steps", "1", "--clicks", "10",
         "--num_points", "512", "--compute_dtype", "float32"]
ROUND_FIELDS = ("round", "wall_s", "select_s", "phase_times", "stats",
                "train_s", "train_steps_s", "eval_s", "steps", "loss_first",
                "loss_last", "losses_finite", "miou", "oa", "k3",
                "live_graphs", "graph_pool_bytes")
CARD_FIELDS = ("warm_step_ms", "replays", "peak_bytes",
               "peak_reserved_bytes", "end_reserved_bytes",
               "end_allocated_bytes", "launches")


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """(records, out dir, work dir) of the twin at the small size."""
    root = tmp_path_factory.mktemp("flagship")
    work, out = str(root / "work"), str(root / "out")
    recs = []
    flagship.main(SMALL + ["--work", work, "--out", out], log=recs.append)
    return recs, out, work


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
    _, out, work = twin
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
    _, out, _ = twin
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
    recs, out, _ = twin
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
        assert r["live_graphs"] == 0               # no graphs on the CPU
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
    assert recs[-1]["miou"] == [r["miou"] for r in rounds]


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
