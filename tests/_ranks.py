"""Run a function on N ranks of one host, for the data-parallel tests and
``chip_smoke.py``'s data-parallel leg (which imports this file from the
``tests`` directory): processes from ``torch.multiprocessing``, joined in
one ``torch.distributed`` group over a file store in a given directory,
their results carried back by ``torch.save``.  A job launched by a user
joins ``torch.distributed.run``'s group instead (``launch/train.py``).
"""
from __future__ import annotations

import datetime
import os
from pathlib import Path
from typing import Any, Callable

import torch
import torch.distributed as dist


def _rank_main(rank: int, fn: Callable, world: int, backend: str, out_dir: str,
               timeout_s: float, args: tuple) -> None:
    dist.init_process_group(backend, init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, *args)
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, *args: Any, out_dir: str | Path,
                backend: str = "gloo", timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes joined in one
    ``backend`` group over a file store in ``out_dir`` (which must exist and
    hold no store yet), and return their results by rank (host objects:
    ``torch.save`` carries them back).  A collective that waits longer than
    ``timeout_s`` raises; if a rank raises, the others are stopped and this
    raises."""
    out_dir = str(Path(out_dir).resolve())
    if os.path.exists(f"{out_dir}/store"):
        raise FileExistsError(f"{out_dir}/store: a file store must start empty")
    torch.multiprocessing.start_processes(_rank_main, args=(fn, world, backend, out_dir,
                                                            timeout_s, args),
                                          nprocs=world, join=True, start_method="spawn")
    return [torch.load(f"{out_dir}/rank{r}.pt", weights_only=False) for r in range(world)]
