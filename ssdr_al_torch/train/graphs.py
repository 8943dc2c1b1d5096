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

The coreGCN fit (active/gcn.py) replays one captured step; a round's
train steps (train/trainer.py::Trainer.train_round) run through StepGraph.
Data-parallel steps and CPU tensors stay eager.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import torch

from ssdr_al_torch.kernels import counts

# eager steps before a capture. The coreGCN fit on an H100 at [4, 512-2048,
# 32] (train/step_times.py --gcn-fit): a graph of 10 steps saved at most
# 12 % a step, graphs of 50 and 250 lost time, eager steps took 5-10× as
# long as one captured step replayed
GRAPH_WARMUP = 3


class Graph:
    """A captured CUDA graph and the kernel launches its capture recorded
    ({kernel: launches}, kernels/counts.py); replay() runs it and adds
    them to the counts."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict[str, int]):
        self.graph = graph
        self.launches = launches
        self.replays = 0

    def replay(self):
        self.graph.replay()
        counts.add(self.launches)
        self.replays += 1


def warm(step: Callable, device):
    """step() on a side stream that waits for the current stream's work
    and that the current stream then waits for: an eager step before a
    capture. Returns step()'s result."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
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
        self.capture_bytes = None

    def __call__(self):
        if self.graph is None:
            if self.eager_steps < GRAPH_WARMUP:
                self.eager_steps += 1
                return warm(self.step, self.device)
            # torch.cuda.graph empties the cache too: what the capture
            # reserves past this is its pool
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            self.graph, self.outputs = capture(self.step, self.generators,
                                               self.device)
            self.capture_s = time.perf_counter() - t0
            self.capture_bytes = torch.cuda.memory_reserved(self.device) \
                - reserved
        self.graph.replay()
        return self.outputs

    def stats(self) -> dict:
        """{eager_steps, replays, capture_s, capture_bytes (the memory the
        graph's pool reserved), launches (its kernels' launches a
        replay)}."""
        g = self.graph
        return dict(eager_steps=self.eager_steps,
                    replays=g.replays if g else 0, capture_s=self.capture_s,
                    capture_bytes=self.capture_bytes,
                    launches={k: v for k, v in (g.launches if g else {})
                              .items() if v})
