"""Data parallelism as torch.distributed ranks (counterpart of
ssdr_al_tpu/parallel/mesh.py).

JAX runs one controller over an n-device mesh: the batch axis is sharded,
parameters are replicated and XLA inserts the reductions, so a dp step IS
the single-device step over the global batch. The port runs one process
per device instead (SPMD): every rank runs the same round with the same
seeds and the same host decisions, keeps its rows of each global batch
(`shard_rows`) and meets the others in collectives where JAX's shardings
put reductions: the BatchNorm statistics, the loss denominator and the
gradient sum of a train step, the evaluator's and the selection's
predictions, the region means and the chamfer blocks. Rank 0 alone writes
files and log lines.

`launch` spawns the ranks with a FileStore rendezvous in a run directory
(no port, no network). Backend: NCCL when every rank has its own card;
gloo on the CPU and when ranks share a card (NCCL refuses two ranks on one
device; gloo's all_reduce and broadcast take CUDA tensors). Host payloads
always travel over a gloo group on the CPU. Every collective waits at
most the group's timeout, so a rank that fails or hangs fails the run.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the longest a rank waits in one collective before it raises (and so
# fails the launch): ranks run the same work between collectives, and
# rank 0's file writes take seconds
COLLECTIVE_TIMEOUT_S = 600


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks, differentiable: rank r's loss reads the sum, so
    the gradient of the total loss with respect to rank r's addend is the
    sum of every rank's gradient with respect to the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass
class DataGroup:
    """One rank's view of the data-parallel group: its rank, the world
    size, its device, the process group of its device tensors and a gloo
    group on the CPU for host payloads."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    cpu_group: Optional[dist.ProcessGroup] = None

    @property
    def lead(self) -> bool:
        """Rank 0: the one rank that writes files and log lines."""
        return self.rank == 0

    @property
    def shares_card(self) -> bool:
        """Whether this rank's card is another rank's too: its device
        tensors' group is gloo (backend_for)."""
        return self.device.type == "cuda" and \
            dist.get_backend(self.group) == "gloo"

    def share(self, n: int) -> slice:
        """This rank's contiguous share of n items, [r·n/m, (r+1)·n/m):
        the rows of a batch (n a multiple of m) or chamfer blocks (any n;
        some ranks may get none)."""
        return slice(self.rank * n // self.size,
                     (self.rank + 1) * n // self.size)

    def shard_rows(self, x):
        """Rows [r·B/m, (r+1)·B/m) of a global [B, ...] batch (numpy or
        torch); B must be a multiple of the world size."""
        b = x.shape[0]
        if b % self.size:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"{self.size} ranks")
        return x[self.share(b)]

    def all_reduce_sum(self, x: torch.Tensor, grad: bool = False):
        """Σ of x over the ranks, the same bits on every rank; with
        grad=True differentiable (the gradient is summed over the ranks
        too). x itself is left as it is."""
        if grad:
            return _AllReduceSum.apply(x, self.group)
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=self.group)
        return y

    def gather_share(self, part: torch.Tensor, n: int) -> torch.Tensor:
        """The [n, ...] whole of which `part` is this rank's `share(n)`,
        on every rank: each rank writes its share into zeros and the
        buffers are summed (x + 0 = x exactly), which every backend
        offers for CUDA tensors."""
        whole = part.new_zeros((n,) + tuple(part.shape[1:]))
        whole[self.share(n)] = part
        dist.all_reduce(whole, group=self.group)
        return whole

    def all_reduce_grads(self, params: Sequence[torch.Tensor]):
        """Sum every parameter's .grad over the ranks, in one flat bucket
        (the total loss is the sum of the ranks' losses)."""
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def gather_host(self, obj) -> list:
        """[obj of rank 0, ..., obj of rank m−1] on every rank, pickled
        over the CPU group."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def gather_rows(self, results: list) -> list:
        """This rank's [(rows, ...) per batch] joined with every other
        rank's: [(rows of rank 0, ..., rows of rank m−1), ...] concatenated
        row-wise, the same on every rank; a None entry stays None."""
        ranks = self.gather_host(results)
        return [tuple(None if parts[0] is None else np.concatenate(parts)
                      for parts in zip(*(r[i] for r in ranks)))
                for i in range(len(results))]

    def broadcast_host(self, obj):
        """Rank 0's obj on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.cpu_group)
        return box[0]

    def broadcast_module(self, module: torch.nn.Module):
        """Rank 0's parameters and buffers on every rank, in place."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0, group=self.group)

    def barrier(self):
        dist.barrier(group=self.cpu_group)


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    cuda = [d for d in devices if d.type == "cuda"]
    if len(cuda) == len(devices) and \
            len({d.index for d in cuda}) == len(cuda):
        return "nccl"
    return "gloo"


def data_devices(device: torch.device | str, n: int) -> List[torch.device]:
    """The devices of n ranks: cuda:0 … cuda:n−1, one card each, or n CPU
    ranks. Raises ValueError when the machine has fewer cards than ranks
    (two ranks are never put on one card silently)."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"--num_devices {n}: needs at least 1")
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    if dev.type != "cuda":
        raise ValueError(f"data parallelism on {dev.type} devices")
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"--num_devices {n} asks for {n} cards but this "
                         f"machine has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def _rank_main(rank, size, device, backend, store_path, threads, fn, args,
               results):
    """One spawned rank: join the group, run fn(group, *args), send back
    (rank, ok, pickled result or traceback)."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, size), rank=rank,
            world_size=size,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            cpu_group = (dist.group.WORLD if backend == "gloo" else
                         dist.new_group(backend="gloo"))
            group = DataGroup(rank, size, dev, dist.group.WORLD, cpu_group)
            out = fn(group, *args)
            results.put((rank, True, pickle.dumps(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, n: int, devices: Sequence, store_dir: str,
           *args) -> list:
    """Run fn(group, *args) on n spawned ranks, rank r on devices[r]
    (backend_for picks the backend); return their results in rank order.

    fn and args are pickled by reference (fn must live in an importable
    module). The FileStore rendezvous lives in a fresh directory under
    store_dir, removed afterwards. Each rank takes this process's torch
    threads divided by n. A rank that raises, or dies without a result,
    fails the launch with its traceback or exit code and the others are
    terminated; a rank left waiting in a collective raises after the
    group's timeout (COLLECTIVE_TIMEOUT_S)."""
    devices = [torch.device(d) for d in devices]
    # "cuda" names this process's current card; a rank must name it
    devices = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d
               for d in devices]
    if len(devices) != n:
        raise ValueError(f"{n} ranks but {len(devices)} devices")
    backend = backend_for(devices)
    os.makedirs(store_dir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="dp-", dir=store_dir)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // n)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n, str(devices[r]), backend, os.path.join(run_dir, "store"),
        threads, fn, args, results)) for r in range(n)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank {dead[0]} of {n} died without a result "
                        f"(exit code {procs[dead[0]].exitcode})") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            if p.is_alive() and len(out) < n:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(run_dir, ignore_errors=True)
    return [out[r] for r in range(n)]
