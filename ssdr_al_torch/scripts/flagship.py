"""The JAX package's flagship AL run on the port, rounds 1-10, through the
port's own entry points, recorded beside JAX's record.

    python -m ssdr_al_torch.scripts.flagship [--rooms 6] [--points 150000] \
        [--rounds 10] [--train_steps 500] [--val_steps 40] [--clicks 150] \
        [--num_points 40960] [--compute_dtype bfloat16] \
        [--trials 0,1,2] [--sorted_trials 0,1,2] \
        [--out results/record_round_flagship_torch] [--work build/flagship] \
        [--busy_round 0] [--device cuda|cpu]

The run of `results/record_round_flagship/` (STATUS.md, "Flagship run";
README.md): the hard synthetic generator, `--rooms` training rooms and one
validation room of `--points` points; a cut-pursuit partition at
reg_strength 0.03 (cli/superpoint.py::run_superpoint); a 1 % seed round
(cli/seed.py::run_seed); then rounds 2..`--rounds` of the full SSDR
sampler t0-sb-clsbal-gcn_fps-WetSU-NAIL-0.9-1-1-0 in one call of
cli/al_loop.py::run_al_loop, so that the rounds share the trainer, the
device pool and the captured graphs as `python -m ssdr_al_torch.cli.
al_loop --rounds 10` does. Each round trains `--train_steps` steps in one
epoch (study C's form of "500 steps a round", ABLATION.md) of bf16
RandLA-Net on `--num_points`-point blocks and evaluates `--val_steps`
crops; each AL round buys `--clicks` clicks. The CLI runs unchanged, in
`--work` (its data root and record_round/ logs), observed only through
the `observe` callback of run_seed and run_al_loop.

Trials: the partition and the seed round run once and every trial starts
from the seed round's snap-1; trial t runs cli.al_loop with `--t t`, as
the JAX package's protocol does (the trial seeds the AL sampler and the
device pool, and keys the trial's state, snapshots and record file by
its sampler string t<t>-...). `--trials` are trials of the default
device pool, whose steps shuffle each block; `--sorted_trials` are
trials of the sorted-block control, whose pooled steps feed the pyramid
the blocks in their distance order, as the JAX pooled step does
(train/device_pool.py; ROADMAP.md §3). The seed round trains on the host
pipeline, whose blocks are shuffled in both packages, so the control
changes the AL rounds only. The control's trials run in `--work`/sorted,
a copy of the work directory made after the seed round, and write their
logs to `--out`/sorted.

Writes to `--out`: the CLI's record_round/ logs (the reference format,
beside JAX's and never over them), rounds.jsonl and SUMMARY.md (every
trial's mIoU and labelled points a region by round beside JAX's, each
round's min, median and max over the trials of an arm, the round walls
and warm steps, with the card's name and power limit). Prints one JSON
line a record: {"event": "device"} (the card), {"event": "flags"} (each
entry point's command line), {"event": "partition"} (a room's knn_ms,
geof_ms, cutpursuit_s and superpoints, the count and, on the card, the
kernel launches), one {"event": "round"} a round (round_record's fields,
with its arm and trial; none for the seed round), on the card {"event":
"k3"} (K3 timed at the last round's chamfer call against its bound) and
{"event": "done"} (the curves, and whether the seed round's files were
left as they were). `--busy_round R` runs round R of the first trial
under torch.profiler, whose record then gains the device-busy share of
the round. The default device is the card; the CPU only with --device
cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_RECORD = os.path.join(REPO, "results", "record_round_flagship")
REG_STRENGTH = 0.03
SEED_PERCENT = 0.01
# the full SSDR sampler of the flagship run, and its cli.al_loop flags
SSDR_ARGS = ["t0", "sb", "clsbal", "gcn_fps", "WetSU", "NAIL", "0.9", "1",
             "1", "0"]
SSDR_FLAGS = ["--sampler", "T", "--t", "0", "--point_uncertainty_mode", "sb",
              "--classbal", "2", "--gcn_fps", "1", "--uncertainty_mode",
              "WetSU", "--oracle_mode", "NAIL", "--threshold", "0.9",
              "--min_size", "1", "--gcn_number", "1", "--gcn_top", "0"]
def trial_flags(argv: list, trial: int) -> list:
    """cli.al_loop's argv with `--t trial`."""
    i = argv.index("--t")
    return argv[:i + 1] + [str(trial)] + argv[i + 2:]


def parse_trials(text: str) -> list:
    """"0,1,2" → [0, 1, 2]; "" → []."""
    out = [int(x) for x in text.split(",") if x.strip()]
    if len(set(out)) != len(out) or any(t < 0 for t in out):
        raise ValueError(f"trials {text!r}: distinct indices ≥ 0")
    return out


def command_lines(args) -> dict:
    """{entry point: its argv} of the run, in `--work`: cli.superpoint,
    cli.seed and cli.al_loop (rounds 2..args.rounds; trial 0, which
    trial_flags changes)."""
    common = ["--device", args.device, "--dataset", "S3DIS", "--data_root",
              "data", "--synthetic", "--synthetic_rooms", str(args.rooms),
              "--synthetic_points", str(args.points), "--reg_strength",
              str(REG_STRENGTH), "--num_points", str(args.num_points),
              "--compute_dtype", args.compute_dtype, "--train_steps",
              str(args.train_steps), "--max_epoch", "1", "--val_steps",
              str(args.val_steps)]
    return {"superpoint": common,
            "seed": common + ["--seed_percent", str(SEED_PERCENT)],
            "al_loop": common + SSDR_FLAGS + [
                "--round", "2", "--rounds", str(args.rounds),
                "--sp_batch_size", str(args.clicks)]}


@contextlib.contextmanager
def working_directory(path: str):
    """The block runs in `path` (the CLI writes record_round/ to the
    working directory)."""
    here = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(here)


@contextlib.contextmanager
def last_chamfer_call():
    """Yields a dict whose "call" is the (points, mask) of the last
    region-graph chamfer call (K3, one a round) inside the block, copied
    to the host, so that the device bytes a round reads are the loop's
    own."""
    from ssdr_al_torch.active import region_graph

    last = {}
    fn = region_graph.chamfer_pairwise_blocks

    def rec(points, mask):
        last["call"] = (points.cpu(), mask.cpu())
        return fn(points, mask)

    region_graph.chamfer_pairwise_blocks = rec
    try:
        yield last
    finally:
        region_graph.chamfer_pairwise_blocks = fn


def graph_summary() -> dict:
    """{live_graphs, graph_pool_bytes} of the process's captured graphs
    (train/graphs.py::live_graphs; a graph's pool is measured at its
    capture)."""
    from ssdr_al_torch.train import graphs

    live = graphs.live_graphs()
    return dict(live_graphs=len(live),
                graph_pool_bytes=sum(g.pool_bytes or 0 for g in live))


class Recorder:
    """The `observe` callback of cli.seed and cli.al_loop: one record a
    round (round_record) tagged with `arm` and `trial`, passed to `emit`.
    At an entry point's setup it sets the device pool's block order to
    `blocks` (device_pool.BLOCK_ORDERS; the seed round has no pool). On the card it resets
    the peak memory statistics and the kernel launch counts at each
    round's start, records the StepGraph's step events, and runs round
    `busy_round` under torch.profiler."""

    def __init__(self, dev: torch.device, emit, busy_round: int = 0):
        self.dev = dev
        self.emit = emit
        self.busy_round = busy_round
        self.cuda = dev.type == "cuda"
        self.trainer = self.sampler = None
        self.arm = self.trial = None
        self.blocks = "shuffled"
        self.next_round = 1
        self.prof = None
        self.steps = []
        self.k3 = {}
        self.k3_calls = []

    @contextlib.contextmanager
    def recording(self):
        """The block's K3 calls and StepGraph steps are recorded."""
        from ssdr_al_torch.scripts.profile_selection import record_k3_calls
        from ssdr_al_torch.train import graphs

        with record_k3_calls() as calls, last_chamfer_call() as last, \
                graphs.record_steps() as steps:
            self.k3_calls, self.k3, self.steps = calls, last, steps
            yield

    def release(self):
        """Drop the references to the last entry point's objects."""
        self.trainer = self.sampler = None

    def __call__(self, event: str, info: dict):
        if event == "setup":
            self.trainer, self.sampler = info["trainer"], info["sampler"]
            pool = info.get("pool")
            if pool is not None:
                pool.blocks = self.blocks
            elif self.blocks != "shuffled":
                raise RuntimeError("the sorted-block control needs the "
                                   "device pool")
        else:
            self.emit(self.round_record(info))
            self.next_round = info["round"] + 1
        self._start_round()

    def _start_round(self):
        from ssdr_al_torch.kernels import counts

        self.k3_calls.clear()
        self.steps.clear()
        counts.reset()
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
            if self.next_round == self.busy_round:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
        self.t0 = time.perf_counter()

    def round_record(self, info: dict) -> dict:
        """{round, arm, trial, wall_s (from the last round's record to
        this one: the restore, the selection, the training and its
        evaluation), select_s (the log's selection costTime), phase_times
        (TSampler's), stats
        (RoundStats), train_s (the log's training costTime: the pool's
        relabelling, the steps and the evaluation), train_steps_s and
        eval_s (Trainer.round_times), steps, loss_first, loss_last,
        losses_finite, miou, oa, k3 (the chamfer calls: calls, [C, S, P]
        shape, valid share, point pairs), live_graphs, graph_pool_bytes};
        on the card also warm_step_ms (the median device time of the
        StepGraph's replays), step_kinds, replays, capture_s,
        step_graph_pool_bytes, launches (by kernel), peak_bytes
        (allocated), peak_reserved_bytes, end_reserved_bytes,
        end_allocated_bytes and, for the busy round, busy
        (step_times.profile_summary)."""
        from ssdr_al_torch.kernels import counts
        from ssdr_al_torch.scripts.profile_selection import k3_summary
        from ssdr_al_torch.train import graphs

        trainer = self.trainer
        if self.cuda:
            torch.cuda.synchronize(self.dev)
        wall = time.perf_counter() - self.t0
        losses = [float(x) for x in trainer.round_losses]
        rec = dict(event="round", round=info["round"], arm=self.arm,
                   trial=self.trial, wall_s=wall,
                   select_s=info["select_s"],
                   phase_times=dict(getattr(self.sampler, "phase_times",
                                            {})),
                   stats=info["stats"].as_dict(), train_s=info["train_s"],
                   train_steps_s=trainer.round_times["train_s"],
                   eval_s=trainer.round_times["eval_s"], steps=len(losses),
                   loss_first=losses[0] if losses else None,
                   loss_last=losses[-1] if losses else None,
                   losses_finite=all(math.isfinite(x) for x in losses),
                   miou=info["miou"], oa=info["oa"],
                   k3=k3_summary(self.k3_calls))
        if self.cuda:
            times = graphs.step_ms(self.steps)
            replays = [ms for kind, ms in times if kind == "replay"]
            gs = trainer.graph_stats or {}
            rec.update(
                warm_step_ms=statistics.median(replays) if replays else None,
                step_kinds={k: sum(1 for kind, _ in times if kind == k)
                            for k in ("eager", "capture", "replay")},
                replays=gs.get("replays"), capture_s=gs.get("capture_s"),
                step_graph_pool_bytes=gs.get("capture_bytes"),
                launches={k: v for k, v in counts.read().items() if v},
                peak_bytes=torch.cuda.max_memory_allocated(self.dev),
                peak_reserved_bytes=torch.cuda.max_memory_reserved(self.dev),
                end_reserved_bytes=torch.cuda.memory_reserved(self.dev),
                end_allocated_bytes=torch.cuda.memory_allocated(self.dev))
            if self.prof is not None:
                from ssdr_al_torch.train.step_times import profile_summary

                prof, self.prof = self.prof, None
                prof.__exit__(None, None, None)
                rec["busy"] = profile_summary(prof, wall)
        rec.update(graph_summary())
        return rec


def k3_timing(points, mask) -> dict:
    """K3 at one chamfer call on the card: {call [C, S, P], valid_share,
    ms (measure.device_ms, 3 runs), bound_ms, bound_by (the least work,
    measure.chamfer_bounds)}."""
    from ssdr_al_torch.kernels import measure
    from ssdr_al_torch.ops import chamfer as ch

    out = ch.chamfer_sums(points, mask)
    (bound_ms, bound_by), _ = measure.chamfer_bounds(points, mask, out)
    return dict(call=list(mask.shape), valid_share=mask.float().mean().item(),
                ms=measure.device_ms(lambda: ch.chamfer_sums(points, mask),
                                     3),
                bound_ms=bound_ms, bound_by=bound_by)


_LINE = re.compile(r"round=\s*(\d+)\s*\|\s*(.*)")


def read_record(path: str) -> dict:
    """{round: {key: number}} of a record_round/ log, or of every log in
    the directory `path` (cli.seed's and cli.al_loop's, the JAX package's
    or the port's): each `key=value` of a `round= N | ...` line, the
    costTime of a labelling line as select_costTime and of a best_miou
    line as train_costTime; the `total_sp_num N[, seeding M]` lines under
    round 0."""
    if os.path.isdir(path):
        out: dict = {}
        for name in sorted(os.listdir(path)):
            if name.endswith(".txt"):
                for r, rec in read_record(os.path.join(path, name)).items():
                    out.setdefault(r, {}).update(rec)
        return out
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("total_sp_num"):
                for part in line.split(","):
                    key, value = part.split()
                    out.setdefault(0, {})[key] = float(value)
                continue
            m = _LINE.match(line)
            if m is None:
                continue
            r = out.setdefault(int(m.group(1)), {})
            cost = ("train_costTime" if "best_miou" in line
                    else "select_costTime")
            for part in m.group(2).split(","):
                key, value = (s.strip() for s in part.split("="))
                r[cost if key == "costTime" else key] = float(value)
    return out


def arm_dir(root: str, arm: str) -> str:
    """The directory of an arm's trials under `root`: root itself for the
    default (shuffled) pool, root/<arm> for the control."""
    return root if arm == "shuffled" else os.path.join(root, arm)


def read_curves(out: str, trials: dict, parsed: dict) -> dict:
    """{arm: {trial: {round: record}}}: each trial's rounds 2.. from its
    log and round 1 from the seed round's, which every trial shares."""
    from ssdr_al_torch.cli.common import record_name

    seed = read_record(os.path.join(out, record_name(parsed["seed"],
                                                     ["seed"])))
    curves = {}
    for arm, ts in trials.items():
        for t in ts:
            rec = read_record(os.path.join(arm_dir(out, arm), record_name(
                parsed["al_loop"], [f"t{t}"] + SSDR_ARGS[1:])))
            curves.setdefault(arm, {})[t] = {1: seed.get(1, {}), **{
                r: v for r, v in rec.items() if r >= 2}}
    return curves


def _fmt(x, fmt="{:.4f}"):
    return "-" if x is None else fmt.format(x)


def _spread(values):
    """"min / median / max" of the values that are not None."""
    v = [x for x in values if x is not None]
    if not v:
        return "-"
    return " / ".join(f"{x:g}" for x in (min(v), statistics.median(v),
                                         max(v)))


def write_summary(path, curves: dict, jax: dict, partition: dict, rounds,
                  card: str, argv: dict):
    """SUMMARY.md: every trial's mIoU and labelled points a region by
    round beside JAX's (read_record of each), with each round's min,
    median and max over an arm's trials; each trial's round walls and
    warm steps (the round records); the superpoint counts, the card and
    the command lines."""
    cols = [(arm, t) for arm, ts in curves.items() for t in ts]
    last = max([1] + [r for c in curves.values() for v in c.values()
                      for r in v] + [r for r in jax if r])
    by = {(r["arm"], r["trial"], r["round"]): r for r in rounds}
    seed = by.get((None, None, 1), {})
    lines = ["# The flagship run on the port beside the JAX package's", "",
             f"Card: {card}.", "",
             f"Superpoints: port {partition['sp_count']}, JAX "
             f"{int(jax.get(0, {}).get('total_sp_num', 0))}. Round 1 is "
             "the seed round, which every trial shares; trial t runs "
             "cli.al_loop --t t. Arms: shuffled (the device pool's "
             "default: each block shuffled) and sorted (the control: "
             "blocks in distance order, as the JAX pooled step feeds "
             "them).", ""]

    def table(title, key, fmt):
        head = ["round", "JAX"] + [f"{a} t{t}" for a, t in cols] + [
            f"{a} min / median / max" for a in curves]
        out = [f"## {title}", "", "| " + " | ".join(head) + " |",
               "|" + " --- |" * len(head)]
        for r in range(1, last + 1):
            row = [str(r), _fmt(key(jax.get(r, {})), fmt)]
            row += [_fmt(key(curves[a][t].get(r, {})), fmt) for a, t in cols]
            row += [_spread([key(curves[a][t].get(r, {})) for t in curves[a]])
                    for a in curves]
            out.append("| " + " | ".join(row) + " |")
        return out + [""]

    lines += table("mIoU", lambda d: d.get("best_miou"), "{:.4f}")
    # the labelling line's (p_num + sub_p_num) / (sp_num + split_sp_num)
    lines += table("Labelled points a region (`labeling mean point`)",
                   lambda d: d.get("labeling mean point"), "{:.1f}")
    head = ["round"] + [f"{a} t{t}" for a, t in cols]
    lines += ["## Round wall s / warm step ms", "",
              "Round 1 (the seed round, shared): wall "
              f"{_fmt(seed.get('wall_s'), '{:.2f}')} s, warm step "
              f"{_fmt(seed.get('warm_step_ms'), '{:.3f}')} ms.", "",
              "| " + " | ".join(head) + " |", "|" + " --- |" * len(head)]
    for r in range(2, last + 1):
        cells = [by.get((a, t, r), {}) for a, t in cols]
        lines.append("| " + " | ".join([str(r)] + [
            f"{_fmt(c.get('wall_s'), '{:.2f}')} / "
            f"{_fmt(c.get('warm_step_ms'), '{:.3f}')}" for c in cells])
            + " |")
    lines += ["", "Command lines, in the work directory (python -m "
              "ssdr_al_torch.cli.<name>; cli.al_loop with --t <trial>, the "
              "sorted arm's in the work directory's copy sorted/):", ""]
    lines += [f"- {name}: `{' '.join(a)}`" for name, a in argv.items()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def card_line() -> str:
    from ssdr_al_torch.scripts.profile_selection import card_line as line

    return line()


def parser():
    from ssdr_al_torch.device import DEFAULT_DEVICE

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rooms", type=int, default=6,
                   help="training rooms (one more validates)")
    p.add_argument("--points", type=int, default=150_000,
                   help="points a room")
    p.add_argument("--rounds", type=int, default=10,
                   help="the last round (1: the seed round only)")
    p.add_argument("--train_steps", type=int, default=500)
    p.add_argument("--val_steps", type=int, default=40)
    p.add_argument("--clicks", type=int, default=150,
                   help="clicks an AL round")
    p.add_argument("--num_points", type=int, default=40960,
                   help="points a training block")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--trials", default="0",
                   help="comma-separated trials of the default device "
                        "pool (shuffled blocks); each runs cli.al_loop "
                        "--t <trial>")
    p.add_argument("--sorted_trials", default="",
                   help="comma-separated trials of the sorted-block "
                        "control (the JAX pooled step's block order)")
    p.add_argument("--out", default=os.path.join(
        REPO, "results", "record_round_flagship_torch"))
    p.add_argument("--work", default=os.path.join(REPO, "build", "flagship"),
                   help="the CLI's data root and record_round/ go here")
    p.add_argument("--busy_round", type=int, default=0,
                   help="run this round of the first trial under "
                        "torch.profiler (card only)")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu")
    return p


def file_digests(top: str) -> dict:
    """{path under top: sha256} of every file under `top`."""
    out = {}
    for d, _, names in os.walk(top):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), top)] = \
                    hashlib.sha256(f.read()).hexdigest()
    return out


def main(argv=None, log=None) -> list:
    """Run the flagship; returns the records, each also passed to `log`
    (default: one JSON line on stdout)."""
    from ssdr_al_torch.cli import al_loop, seed, superpoint
    from ssdr_al_torch.device import resolve_device
    from ssdr_al_torch.kernels import counts

    args = parser().parse_args(argv)
    trials = {arm: ts for arm, ts in (
        ("shuffled", parse_trials(args.trials)),
        ("sorted", parse_trials(args.sorted_trials))) if ts}
    if args.rounds < 2:
        trials = {}
    elif not trials:
        raise ValueError("no trial to run: give --trials or --sorted_trials")
    dev = resolve_device(args.device)
    records = []

    def emit(rec):
        records.append(rec)
        if log is None:
            print(json.dumps(rec), flush=True)
        else:
            log(rec)

    card = "cpu"
    if dev.type == "cuda":
        from ssdr_al_torch.kernels import build

        card = card_line()
        emit({"event": "device", "kind": torch.cuda.get_device_name(dev),
              "card": card})
        build.library()
    work = os.path.abspath(args.work)
    out = os.path.abspath(args.out)
    # once a call: the trials share the partition and the seed round
    for sub in ("data", "record_round", "sorted"):
        shutil.rmtree(os.path.join(work, sub), ignore_errors=True)
    shutil.rmtree(os.path.join(out, "sorted"), ignore_errors=True)
    os.makedirs(work, exist_ok=True)
    os.makedirs(out, exist_ok=True)
    argv_of = command_lines(args)
    parsed = {name: mod.parser().parse_args(argv_of[name]) for name, mod in
              (("superpoint", superpoint), ("seed", seed),
               ("al_loop", al_loop))}
    if al_loop.build_sampler_args(parsed["al_loop"]) != SSDR_ARGS:
        raise AssertionError("the al_loop flags name another sampler")
    emit({"event": "flags", **argv_of})
    recorder = Recorder(dev, emit, args.busy_round)
    t_run = time.perf_counter()
    seed_dirs = [os.path.join("data", parsed["seed"].dataset,
                              str(parsed["seed"].reg_strength), *sub)
                 for sub in (("sampling", "seed"), ("saver", "seed"))]
    with working_directory(work), recorder.recording():
        counts.reset()
        t0 = time.perf_counter()
        total, times = superpoint.run_superpoint(parsed["superpoint"])
        partition = dict(event="partition", sp_count=total["sp_num"],
                         wall_s=time.perf_counter() - t0, rooms=times,
                         mean_size=total["point_num"] / total["sp_num"])
        if dev.type == "cuda":
            partition["launches"] = {k: v for k, v in counts.read().items()
                                     if v}
        emit(partition)
        seed.run_seed(parsed["seed"], observe=recorder)
        recorder.release()
        seed_files = {d: file_digests(d) for d in seed_dirs}
        # the control's work directory: the partition and the seed round
        # as they are before any trial
        for arm in trials:
            if arm_dir(work, arm) != work:
                os.makedirs(arm_dir(work, arm))
                shutil.copytree("data", os.path.join(arm_dir(work, arm),
                                                     "data"))
        for arm, ts in trials.items():
            where = arm_dir(work, arm)
            recorder.blocks = arm         # the arm names its block order
            with working_directory(where):
                for t in ts:
                    recorder.arm, recorder.trial = arm, t
                    al_loop.run_al_loop(al_loop.parser().parse_args(
                        trial_flags(argv_of["al_loop"], t)),
                        observe=recorder)
                    recorder.release()
                    recorder.busy_round = 0
        # no trial wrote to the seed round's state or snapshot
        seed_shared = all(
            file_digests(os.path.join(arm_dir(work, arm), d)) ==
            seed_files[d] for arm in trials for d in seed_dirs)
        if dev.type == "cuda" and "call" in recorder.k3:
            emit(dict(event="k3", round=args.rounds, **k3_timing(
                *(t.to(dev) for t in recorder.k3.pop("call")))))
    rounds = [r for r in records if r.get("event") == "round"]
    for arm in ("shuffled",) + tuple(a for a in trials if a != "shuffled"):
        src = os.path.join(arm_dir(work, arm), "record_round")
        dst = arm_dir(out, arm)
        os.makedirs(dst, exist_ok=True)
        for name in os.listdir(src) if os.path.isdir(src) else ():
            shutil.copy(os.path.join(src, name), dst)
    curves = read_curves(out, trials, parsed)
    jax = read_record(JAX_RECORD) if os.path.isdir(JAX_RECORD) else {}
    seed_miou = next((r["miou"] for r in rounds if r["round"] == 1), None)
    emit({"event": "done", "wall_s": time.perf_counter() - t_run,
          "seed_shared": seed_shared, "seed_miou": seed_miou,
          "curves": {arm: {str(t): [seed_miou] + [
              r["miou"] for r in rounds if (r["arm"], r["trial"]) ==
              (arm, t)] for t in ts} for arm, ts in trials.items()},
          "jax_miou": [jax[r]["best_miou"] for r in sorted(jax) if r
                       and "best_miou" in jax[r]]})
    with open(os.path.join(out, "rounds.jsonl"), "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    write_summary(os.path.join(out, "SUMMARY.md"), curves, jax, partition,
                  rounds, card, argv_of)
    return records


if __name__ == "__main__":
    main()
