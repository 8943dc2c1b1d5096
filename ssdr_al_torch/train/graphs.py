"""CUDA graphs of the port's device programs, the counterpart of JAX's
jitted steps and lax.scan: a step is captured once on the card and
replayed, one launch a step from the host instead of hundreds.

torch's recipe: a few eager steps on a side stream first (they make the
kernels' first launches, with their shared-memory opt-ins, the optimiser's
state and the allocator's blocks), then the step captured in a CUDA graph,
which reads and writes the same device tensors at every replay. Every
torch.Generator the step draws from is registered with the graph, so that
each replay draws the next values of its stream, as eager steps would.
The capture runs with capture_error_mode="thread_local": another thread's
CUDA calls (the host pipeline's prefetch) do not break it, this thread's
host syncs do, and a capture that fails raises. The kernel launch counts
(kernels/counts.py) of a capture are taken back, since the capture runs
nothing, and added at every replay.

The loops of n steps of one static step, JAX's lax.fori_loop and
lax.scan programs, run through run_steps: the coreGCN fit (active/gcn.py)
and the greedy selection loops (ops/fps.py, ops/kcenter.py). A round's
train steps (train/trainer.py::Trainer.train_round) run through
StepGraph; the eval step and the programs fused onto it (train/
trainer.py::EvalStep) through ForwardGraphs. Data-parallel steps and CPU
tensors stay eager.
"""

from __future__ import annotations

import collections
import contextlib
import time
import weakref
from typing import Callable, Dict, Hashable, Sequence

import torch

from ssdr_al_torch.kernels import counts

# eager steps before a capture. The coreGCN fit on an H100 at [4, 512-2048,
# 32] (train/step_times.py --gcn-fit): a graph of 10 steps saved at most
# 12 % a step, graphs of 50 and 250 lost time, eager steps took 5-10× as
# long as one captured step replayed
GRAPH_WARMUP = 3
# captured forwards an eval step keeps (ForwardGraphs), the least recently
# used dropped first: a trainer's evaluation and selection shapes, with
# room for two more (JAX keeps 8 fused selection programs an eval step,
# ssdr_al_tpu/active/samplers.py:125)
FORWARD_GRAPHS = 4
# the open record_runs() lists, each taking every run_steps call's stats
_RECORDS: list = []
# the open record_steps() lists, each taking every StepGraph call's events
_STEP_RECORDS: list = []
# every Graph not yet collected (live_graphs)
_LIVE: "weakref.WeakSet[Graph]" = weakref.WeakSet()
# warm()'s side stream of each device (side_stream)
_SIDE_STREAMS: dict = {}


class Graph:
    """A captured CUDA graph and the kernel launches its capture recorded
    ({kernel: launches}, kernels/counts.py); replay() runs it and adds
    them to the counts."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict[str, int]):
        self.graph = graph
        self.launches = launches
        self.replays = 0
        self.pool_bytes = None      # measured_capture's reading
        _LIVE.add(self)

    def replay(self):
        self.graph.replay()
        counts.add(self.launches)
        self.replays += 1


def side_stream(current):
    """warm()'s side stream beside the stream `current`: one a device, made
    at its first use. torch.cuda.Stream() hands out the next stream of a
    pool of 32, and cuBLAS keeps a workspace for every stream it has run
    on, so a new side stream a warm step made a process hold a workspace
    more each time, up to 32 (on an H100, ~0.1 GB more a training round
    of the flagship loop)."""
    side = _SIDE_STREAMS.get(current.device)
    if side is None:
        side = _SIDE_STREAMS[current.device] = torch.cuda.Stream(
            current.device)
    return side


def warm(step: Callable, device):
    """step() on a side stream that waits for the current stream's work
    and that the current stream then waits for: an eager step before a
    capture. Returns step()'s result."""
    current = torch.cuda.current_stream(device)
    side = side_stream(current)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = step()
    current.wait_stream(side)
    return out


def capture(step: Callable, generators: Sequence[torch.Generator], device):
    """(Graph, out): step() captured in one CUDA graph on `device`, not run,
    with each of `generators` registered with it; out is what step()
    returned, the tensors each replay writes. A capture that fails
    raises."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = counts.read()
    with torch.cuda.device(device), torch.cuda.graph(
            graph, capture_error_mode="thread_local"):
        out = step()
    launched = counts.since(before)
    counts.add(launched, -1)      # the capture launched nothing
    return Graph(graph, launched), out


def capture_steps(step: Callable, n: int, warmup: int,
                  generators: Sequence[torch.Generator], device) -> Graph:
    """`warmup` eager steps (warm), then n steps captured in one graph,
    not run (capture)."""
    for _ in range(warmup):
        warm(step, device)
    graph, _ = capture(lambda: [step() for _ in range(n)], generators,
                       device)
    return graph


def capturable(device: torch.device) -> bool:
    """Whether steps on `device` can be captured: the card's."""
    return device.type == "cuda"


def run_steps(step: Callable, n: int, device, *,
              generators: Sequence[torch.Generator] = (), eager=False,
              min_replays: int = 1, name: str = "steps"):
    """step() n times, where step is static (it reads and writes the same
    tensors at every call, and advances on the device whatever position
    it keeps): the counterpart of a lax.fori_loop or lax.scan whose body
    is step. On the card GRAPH_WARMUP eager steps (warm), then one step
    captured in a CUDA graph (with `generators` registered; a capture
    that fails raises) and replayed n − GRAPH_WARMUP times. CPU tensors,
    eager=True and loops that would replay fewer than `min_replays`
    times run a Python loop of the same step. Inside record_runs() the
    run's stats are recorded under `name`."""
    device = torch.device(device)
    graphed = capturable(device) and not eager and \
        n - GRAPH_WARMUP >= max(min_replays, 1)
    record = bool(_RECORDS) and capturable(device)
    if record:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
    graph = capture_s = None
    if graphed:
        for _ in range(GRAPH_WARMUP):
            warm(step, device)
        graph, _, capture_s = measured_capture(step, generators, device)
        for _ in range(n - GRAPH_WARMUP):
            graph.replay()
    else:
        for _ in range(n):
            step()
    if record:
        torch.cuda.synchronize(device)
        stats = dict(name=name, steps=n, wall_s=time.perf_counter() - t0,
                     replays=graph.replays if graph else 0,
                     capture_s=capture_s,
                     capture_bytes=graph.pool_bytes if graph else None,
                     launches={k: v for k, v in graph.launches.items()
                               if v} if graph else {})
        for runs in _RECORDS:
            runs.append(stats)


@contextlib.contextmanager
def record_runs():
    """Inside the block every run_steps call on the card appends {name,
    steps, wall_s (to a synchronize before and after), replays,
    capture_s, capture_bytes (its graph pool), launches (a replay's, by
    kernel)} to the list this yields. For measurement: it synchronizes
    the device around each run."""
    runs: list = []
    _RECORDS.append(runs)
    try:
        yield runs
    finally:
        _RECORDS.remove(runs)


def measured_capture(step: Callable, generators: Sequence[torch.Generator],
                     device):
    """(Graph, out, capture_s): capture() timed, and the memory its pool
    reserved kept as the Graph's pool_bytes. torch.cuda.graph empties
    the cache too, so what the capture reserves past an emptied cache is
    its pool."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    graph, out = capture(step, generators, device)
    graph.pool_bytes = torch.cuda.memory_reserved(device) - reserved
    return graph, out, time.perf_counter() - t0


def live_graphs() -> list:
    """Every captured Graph of the process not yet collected (a graph
    holds its memory pool while it lives): the kept eval-step captures,
    a round's StepGraph, a greedy loop's or fit's graph while it runs,
    and any that something still references."""
    return list(_LIVE)


@contextlib.contextmanager
def record_steps():
    """Inside the block every StepGraph call on the card appends (kind,
    start, end) to the list this yields: kind "eager", "capture" (the
    call that captures and replays) or "replay", and two CUDA events
    recorded on the current stream before and after the call (nothing
    synchronizes; step_ms reads them). For measurement."""
    steps: list = []
    _STEP_RECORDS.append(steps)
    try:
        yield steps
    finally:
        _STEP_RECORDS.remove(steps)


def step_ms(steps) -> list:
    """[(kind, device ms)] of record_steps' entries, after a
    synchronize."""
    torch.cuda.synchronize()
    return [(kind, start.elapsed_time(end)) for kind, start, end in steps]


class StepGraph:
    """A train step as a replayed CUDA graph. step() runs one step from
    static tensors that the caller fills before each call and returns its
    outputs. The first GRAPH_WARMUP calls run it eagerly (warm); the next
    captures it (capture) and replays it, and so does every call after.
    A call returns the step's outputs: the graph's static tensors from the
    capture on, which the next replay overwrites. The graph has its own
    memory pool; its owner keeps one graph at a time (a trainer drops a
    round's graph at the round's end)."""

    def __init__(self, step: Callable, generators: Sequence[torch.Generator],
                 device):
        self.step = step
        self.generators = tuple(generators)
        self.device = device
        self.eager_steps = 0
        self.graph = None
        self.outputs = None
        self.capture_s = None

    def __call__(self):
        if not _STEP_RECORDS:
            return self._call()[1]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        kind, out = self._call()
        end.record()
        for steps in _STEP_RECORDS:
            steps.append((kind, start, end))
        return out

    def _call(self):
        """(kind, outputs) of one step: kind as record_steps names it."""
        kind = "replay"
        if self.graph is None:
            if self.eager_steps < GRAPH_WARMUP:
                self.eager_steps += 1
                return "eager", warm(self.step, self.device)
            self.graph, self.outputs, self.capture_s = measured_capture(
                self.step, self.generators, self.device)
            kind = "capture"
        self.graph.replay()
        return kind, self.outputs

    def stats(self) -> dict:
        """{eager_steps, replays, capture_s, capture_bytes (the memory the
        graph's pool reserved), launches (its kernels' launches a
        replay)}."""
        g = self.graph
        return dict(eager_steps=self.eager_steps,
                    replays=g.replays if g else 0, capture_s=self.capture_s,
                    capture_bytes=g.pool_bytes if g else None,
                    launches={k: v for k, v in (g.launches if g else {})
                              .items() if v})


class _Forward:
    """One captured forward of ForwardGraphs: its staged inputs, graph and
    static outputs, and what it keeps alive."""

    def __init__(self, inputs, graph: Graph, outputs, keep):
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.keep = keep


class ForwardGraphs:
    """Eval-mode programs as replayed CUDA graphs, one capture per static
    key, kept across calls: the counterpart of JAX's cache of the jitted
    eval step and of its lru_cache of fused selection programs
    (ssdr_al_tpu/active/samplers.py:125), which live on the eval step
    object across evaluations and rounds.

    call(key, make, batch): `key` names what a capture depends on (the
    program, the input shapes, the data pointers of the state it reads);
    make() → (inputs, fn, keep) is called at a new key: `inputs` has
    stage(batch) that writes the batch into static device tensors, fn()
    runs the program from them and returns its output tensors, and `keep`
    (the state read) stays referenced while the capture lives, so that its
    addresses cannot be reused by other tensors. A new key stages the
    batch, runs GRAPH_WARMUP eager calls (warm) and captures fn() (a
    failed capture raises); every call then stages its batch and replays.
    A call returns copies of the static outputs, made on the device in
    stream order: the next replay overwrites the static outputs, never
    what a caller holds. The programs read no generator. At most
    FORWARD_GRAPHS captures are kept, the least recently used dropped
    first, with its pool."""

    def __init__(self, device):
        self.device = device
        self.forwards: "collections.OrderedDict[Hashable, _Forward]" = \
            collections.OrderedDict()
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def __call__(self, key: Hashable, make: Callable, batch):
        fwd = self.forwards.get(key)
        if fwd is None:
            inputs, fn, keep = make()
            inputs.stage(batch)
            for _ in range(GRAPH_WARMUP):
                warm(fn, self.device)
            graph, outputs, capture_s = measured_capture(fn, (), self.device)
            fwd = self.forwards[key] = _Forward(inputs, graph, outputs, keep)
            self.captures += 1
            self.capture_s += capture_s
            while len(self.forwards) > FORWARD_GRAPHS:
                self.forwards.popitem(last=False)
        else:
            self.forwards.move_to_end(key)
            fwd.inputs.stage(batch)
        fwd.graph.replay()
        self.replays += 1
        return tuple(o.clone() for o in fwd.outputs)

    def stats(self) -> dict:
        """{captures, replays, capture_s (all captures'), graphs (kept),
        capture_bytes (the kept graphs' pools), launches (each kept
        graph's kernel launches a replay)}."""
        return dict(captures=self.captures, replays=self.replays,
                    capture_s=self.capture_s, graphs=len(self.forwards),
                    capture_bytes=sum(f.graph.pool_bytes
                                      for f in self.forwards.values()),
                    launches=[{k: v for k, v in f.graph.launches.items() if v}
                              for f in self.forwards.values()])
