"""The port-side twins of scripts/ on the CPU: the sampler-ablation twin
(python -m ssdr_al_torch.scripts.ablation) against scripts/ablation.py's
setup, seed round and records, and every `python -m ssdr_al_tpu.cli.*`
command line of the protocol scripts parsed by the port's CLI parsers."""

import ast
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROTOCOL_SCRIPTS = ("rebuttal_run", "run_sota_comparison", "run_semantic3d",
                    "run_semantic3d_0.012", "run_add_t200",
                    "run_graph_reasoning_analysis", "run_threshold_analysis")
SEP = "\x1f"

torch.set_num_threads(1)


def _command_lines(script):
    """The argv of every `python ...` the script runs, its loops and
    variables expanded by bash with a stand-in `python` that prints its
    arguments and runs nothing."""
    code = ("python() { printf '%s" + SEP + "' \"$@\"; printf '\\n'; }\n"
            f"source scripts/{script}.sh\n")
    res = subprocess.run(["bash", "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return [line.split(SEP)[:-1] for line in res.stdout.splitlines()]


@pytest.mark.parametrize("script", PROTOCOL_SCRIPTS)
def test_protocol_script_flags_parse_with_the_port(script):
    """Each command line, with ssdr_al_torch in place of ssdr_al_tpu, is
    accepted by the port's parser of that CLI, and keeps every value it
    gives."""
    lines = _command_lines(script)
    assert lines
    for argv in lines:
        assert argv[0] == "-m" and argv[1].startswith("ssdr_al_tpu.cli."), argv
        mod = importlib.import_module(
            argv[1].replace("ssdr_al_tpu", "ssdr_al_torch", 1))
        args = vars(mod.parser().parse_args(argv[2:]))
        flags = [a for a in argv[2:] if a.startswith("--")]
        for flag in flags:
            value = argv[argv.index(flag) + 1]
            assert str(args[flag[2:]]) == value or \
                float(args[flag[2:]]) == float(value), (flag, value, args)


def _jax_record_keys():
    """The key sets of the dict literals scripts/ablation.py logs."""
    with open(os.path.join(REPO, "scripts", "ablation.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and all(
                isinstance(k, ast.Constant) for k in node.keys):
            ks = tuple(sorted(k.value for k in node.keys))
            if "sampler" in ks or "event" in ks:
                keys.add(ks)
    return keys


def test_ablation_twin_matches_jax_setup_seed_round_and_records(tmp_path):
    """The twin at --rooms 2 --points 4000 --rounds 2 --train_steps 2
    --max_epoch 1 on the CPU: its setup record's total_sp and its seed
    round's registry and pseudo labels equal those scripts/ablation.py's
    functions give for the same flags (make_dataset, compute_superpoints
    on the host, SeedSampler seed 0); every record it shares with the JAX
    script has the JAX script's keys; scripts/ablation_summary.py merges
    its JSONL."""
    from ssdr_al_tpu.active.samplers import SeedSampler as JSeed
    from ssdr_al_tpu.active.state import ALState as JState
    from ssdr_al_tpu.active.state import RoundStats as JStats
    from ssdr_al_tpu.data.synthetic import make_dataset as jmake
    from ssdr_al_tpu.partition.superpoint import compute_superpoints as jcs
    from ssdr_al_torch.active.state import ALState
    from ssdr_al_torch.scripts import ablation

    work = tmp_path / "torch"
    recs = []
    ablation.main(["--rooms", "2", "--points", "4000", "--rounds", "2",
                   "--train_steps", "2", "--max_epoch", "1", "--configs",
                   "random", "--device", "cpu", "--workdir", str(work),
                   "--out", str(tmp_path / "abl.md")], log=recs.append)

    jwork = str(tmp_path / "jax")
    train, _ = jmake(num_train=2, num_val=1, num_points=4000, hard=True)
    total = jcs(train, JState(jwork, ["partition"]), 0.03,
                log=lambda *a: None)
    seed_state = JState(jwork, ["seed"])
    JSeed(seed_state, train, total["sp_num"], seed=0).sampling(
        max(1, int(total["sp_num"] * 0.01)), 0, JStats())

    setup = next(r for r in recs if r.get("event") == "setup")
    assert setup == {"event": "setup", "total_sp": total["sp_num"],
                     "clicks_per_round": 40, "rounds": 2}
    got_state = ALState(str(work), ["seed"])
    r1, jr1 = got_state.round_dir(1), seed_state.round_dir(1)
    assert got_state.load_registry(r1) == seed_state.load_registry(jr1)
    for c in train:
        np.testing.assert_array_equal(got_state.load_pseudo_gt(r1, c.name),
                                      seed_state.load_pseudo_gt(jr1, c.name))

    jax_keys = _jax_record_keys()
    shared = [r for r in recs if r.get("event") in ("setup", "done", None)]
    assert {r.get("sampler") for r in shared} == {None, "seed", "random"}
    for r in shared:
        assert tuple(sorted(r)) in jax_keys, r
    rounds = [r for r in recs if r.get("sampler") == "random"]
    assert [r["round"] for r in rounds] == [2]
    assert all(np.isfinite(r["miou"]) and np.isfinite(r["oa"])
               for r in rounds)

    jsonl = tmp_path / "abl_t0.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in recs))
    out = tmp_path / "summary.md"
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "ablation_summary.py"),
         str(jsonl), "--out", str(out)], capture_output=True, text=True,
        timeout=60)
    assert res.returncode == 0, res.stderr
    assert "| round | random |" in out.read_text()
