"""Processes of a mesh: joining the process group, and spawning one
process a rank.

JAX drives every device of a mesh from one process. Here each rank is a
process: started by ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; :func:`init` with no
rank reads them), or by :func:`spawn`, which starts ``world`` processes
with the ``spawn`` method and joins them through a ``file://`` store in a
temporary directory (no TCP port for concurrent runs to race for).

NCCL takes one card a rank; several ranks on one card (or on the CPU)
take gloo, whose collectives on CUDA tensors go through host memory.
``torch.distributed`` is imported inside the functions, so importing this
module stays cheap.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch

# Seconds a collective may wait for its peers before it fails.
COLLECTIVE_TIMEOUT_S = 600.0


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank`` for a ``device`` of "cpu" or "cuda": CUDA
    ranks take the cards in turn (rank % cards), so several ranks share a
    card when there are fewer cards than ranks."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def init(backend: Optional[str] = None, rank: Optional[int] = None,
         world_size: Optional[int] = None, store_path: Optional[str] = None,
         device="cuda") -> torch.device:
    """Join the default process group and return this rank's device (made
    the current CUDA device where it is one).

    With ``rank`` None, the rank, world size and rendezvous come from
    ``torchrun``'s environment (``env://``, ``LOCAL_RANK`` picks the
    card); else from ``rank``, ``world_size`` and the ``file://`` store at
    ``store_path``. ``backend`` defaults to NCCL for a CUDA device and gloo
    for the CPU."""
    import torch.distributed as dist

    if rank is None:
        rank = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = rank_device(device, local)
        init_method, world_size = "env://", int(os.environ["WORLD_SIZE"])
    else:
        if world_size is None or store_path is None:
            raise ValueError("an explicit rank needs world_size and store_path")
        dev = rank_device(device, rank)
        init_method = f"file://{store_path}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dev


def _child(fn: Callable, rank: int, world: int, backend: str, device: str,
           tmp: str, args: tuple) -> None:
    """One rank: join the group, run ``fn(*args)``, write its return value
    (or the traceback) under ``tmp``, leave the group."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}")
    try:
        init(backend, rank, world, os.path.join(tmp, "store"), device)
        result = fn(*args)
        with open(out + ".pkl.part", "wb") as f:
            pickle.dump(result, f)
        os.replace(out + ".pkl.part", out + ".pkl")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args: Any, backend: str = "gloo",
          device: str = "cpu", timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks, each a process started with the
    ``spawn`` method (never ``fork``: the parent may hold CUDA and
    threads) that has joined the process group (``backend``, ``device``
    as :func:`init` takes them) and runs on one CPU thread. ``fn`` must be
    importable by its module path (a spawned child cannot import a test
    module) and its arguments and return value picklable.

    Returns the ranks' return values in rank order. A rank that raises or
    exits with another code than 0 makes this raise ``RuntimeError`` with
    its traceback, after the others are stopped (they would wait forever
    in their next collective); so does ``timeout_s`` passing."""
    import multiprocessing.connection as mpc

    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="twt_spawn_") as tmp:
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(fn, r, world, backend, device, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        failed = None
        deadline = time.monotonic() + timeout_s
        try:
            running = list(procs)
            while running and failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failed = "timed out after %.0f s" % timeout_s
                    break
                mpc.wait([p.sentinel for p in running], timeout=left)
                for p in [p for p in running if not p.is_alive()]:
                    running.remove(p)
                    p.join()
                    if p.exitcode != 0:
                        r = procs.index(p)
                        err = os.path.join(tmp, f"rank{r}.err")
                        text = (open(err).read() if os.path.exists(err)
                                else "no traceback")
                        failed = f"rank {r} exited with {p.exitcode}:\n{text}"
                        break
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failed is not None:
            raise RuntimeError(f"spawn of {world} ranks failed: {failed}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
