"""Run one function on N spawned ranks joined by a process group.

    run_ranks(fn, 4, backend="gloo", device="cpu", shape=(2, 2), args=...)

spawns four processes (the `spawn` start method: each imports the port
afresh), joins them by `init_distributed` over
tcp://localhost:<a free port>, calls fn(mesh, device, *args) in each and
returns the four results in rank order.  `fn` must be importable by name
(a module-level function), and its result picklable.  The first rank that
raises fails the call with its traceback, and no rank is left running.
This is how the tests, `entry.dryrun_multichip`, `bench/scaling.py` and
chip_smoke.py drive several ranks on one machine; a deployment launches
its ranks with torchrun instead (tpdlp_torch/cli/main.py --mesh).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_devices(world: int, device, backend: str):
    """The device of each of `world` ranks on `device`'s kind under
    `backend`: "gloo" runs the ranks on the CPU, or on CUDA sharing the
    cards round-robin (gloo stages CUDA tensors through the host); "nccl"
    gives each rank a card of its own, and raises where there are fewer
    cards than ranks (NCCL refuses two ranks on one card) or no card."""
    import torch

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"rank_devices: backend {backend!r}, expected "
                         "'gloo' or 'nccl'")
    if torch.device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("rank_devices: NCCL needs CUDA ranks; use "
                             "gloo on the CPU")
        return "cpu"
    cards = torch.cuda.device_count()
    if backend == "nccl" and world > cards:
        raise ValueError(f"rank_devices: {world} NCCL ranks need {world} "
                         f"cards, this machine has {cards}; use gloo for "
                         "ranks that share a card")
    return [f"cuda:{i % cards}" for i in range(world)]


def _rank_main(rank, world, port, backend, device, shape, fn, args, out,
               timeout):
    import torch
    import torch.distributed as dist

    from tpdlp_torch.shard.mesh import init_distributed

    try:
        dev = torch.device(device[rank] if isinstance(device, (list, tuple))
                           else device)
        if dev.type == "cpu":
            # Ranks share the host's cores.
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        mesh = init_distributed(
            backend, shape=shape, init_method=f"tcp://localhost:{port}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        out.put((rank, True, fn(mesh, dev, *args)))
    except BaseException:  # reported to the parent, which stops the rest
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *, backend: str, device, shape=None, args=(),
              timeout: float = 600.0) -> list:
    """[fn(mesh, device, *args) on rank r for r in range(world)].

    `device`: one device for every rank ("cpu", or "cuda:0" for ranks that
    share a card under gloo) or a list of one per rank (NCCL: each its
    own GPU).  `timeout` bounds the whole call in seconds, and each
    collective as well."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, device, shape, fn,
                               args, out, timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, value = out.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"run_ranks: {world - len(results)} of "
                                   f"{world} ranks gave no result within "
                                   f"{timeout} s") from None
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if len(results) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]
