"""Rank bodies of the CPU mesh tests (``tests/test_torch_dist*.py``):
gloo worlds of spawned processes meet through a ``FileStore`` under the
test's ``tmp_path`` (pytest-xdist runs several workers at once, so no TCP
port is shared). This module imports torch, numpy and the port only: a
rank never imports jax. The parent computes the reference's numbers and
hands the ranks numpy arrays; each rank returns picklable results."""
from __future__ import annotations

import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store_dir, fn, args, out_dir):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        result = ("ok", fn(rank, world, *args))
    except Exception:
        result = ("error", traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(world: int, fn, tmp_dir, *args, timeout: float = 600.0):
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks;
    returns the list of their results (raises with a rank's traceback if
    one failed, and stops the ranks if they outlast ``timeout`` s)."""
    tmp_dir = str(tmp_dir)
    run_dir = os.path.join(tmp_dir, f"world{len(os.listdir(tmp_dir))}")
    os.makedirs(run_dir)
    ctx = mp.start_processes(_entry, args=(world, run_dir, fn, args,
                                           run_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a gloo world of {world} ranks ran past "
                               f"{timeout} s")
    out = []
    for r in range(world):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} failed:\n{value}")
        out.append(value)
    return out
