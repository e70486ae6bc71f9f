"""Run a function on every rank of a data group of spawned processes.

The tests, ``experiments/dryrun_multihost.py`` and ``chip_smoke.py``
start their groups here rather than through torchrun: the ranks meet at
a ``file://`` store in a fresh temporary directory (no fixed port, so
groups started side by side do not collide), each process uses one CPU
thread, and every rank's result or traceback comes back to the caller.
"""

from __future__ import annotations

import datetime
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from voicepuppet_torch.parallel.mesh import make_mesh


def _rank_main(fn, rank: int, world: int, store: str, device: str,
               backend: Optional[str], timeout_s: float, args, results):
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, fn(make_mesh(device), *args)))
    except BaseException:  # the parent re-raises it with the traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, device: str = "cpu",
              backend: Optional[str] = None,
              timeout: float = 600.0) -> List[Any]:
    """``[fn(mesh, *args) for each rank]``, computed in ``world`` spawned
    processes that form one data group on ``device`` (``cuda:0`` puts
    every rank on one card).  ``fn`` must be a module-level function and
    return picklable data (numpy arrays, not tensors).  A rank that
    raises, or a group that outlives ``timeout`` seconds, fails the call
    with a ``RuntimeError``; every process is stopped before it
    returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = f"{tmp}/store"
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, store, device, backend,
                                   timeout, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                try:
                    rank, ok, value = results.get(timeout=max(left, 0.1))
                except queue_mod.Empty:
                    raise RuntimeError(
                        f"{world - len(got)} of {world} ranks did not "
                        f"finish within {timeout} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [got[r] for r in range(world)]
