"""Starting the ranks of a data-parallel run from one command.

`command_world(num_devices)` and `run_command(...)` are what the entry
points (`train_torch.py`, `evaluate_torch.py`) call: run here, as the only
rank or as one rank of a group a caller or torchrun set, or start the ranks.
`spawn(fn, world, args, backend=..., rendezvous_dir=...)` starts `world`
processes with the `spawn` context; rank r joins the process group through
a `file://` rendezvous under `rendezvous_dir`, calls `fn(*args)` and leaves
the group. A rank that raises or dies fails the run: the parent stops every
other rank (none is left waiting in a collective) and raises. Under a
launcher that starts the ranks itself (torchrun), `env_ranks()` reads
`RANK` / `WORLD_SIZE` / `LOCAL_RANK` and the ranks join with `env://`.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Callable, Optional, Sequence, Tuple

import torch.multiprocessing as mp

from . import mesh


def command_world(num_devices: Optional[int]) -> int:
    """The ranks a command runs on: the group's a caller set, torchrun's
    WORLD_SIZE, or `num_devices` (1 by default); raises when
    `num_devices` says otherwise than the group or torchrun."""
    env = env_ranks()
    world = mesh.world() if mesh.active() else env[1] if env else (num_devices or 1)
    if num_devices is not None and num_devices != world:
        raise ValueError(f"--num-devices {num_devices}, but the process group holds {world} ranks")
    return world


def run_command(run: Callable, rank_main: Callable, argv: Sequence[str], world: int, device: Optional[str],
                rendezvous_dir: str):
    """Run a command of `world` ranks (`command_world`): `run()` here when
    this process is its only rank or one rank of a group a caller or
    torchrun set (returning what it returns), else `world` processes each
    calling `rank_main(argv)` in a group (nccl a card on CUDA, gloo on the
    CPU; more ranks than cards raises), returning None."""
    env = env_ranks()
    if mesh.active() or (env is None and world == 1):
        return run()
    device = device or "cuda"
    backend = mesh.default_backend(device)
    if env is not None:  # torchrun started this rank
        mesh.init_process_group(backend, env[0], env[1], "env://")
        try:
            return run()
        finally:
            mesh.destroy_process_group()
    mesh.check_num_devices(world, device)
    spawn(rank_main, world, (list(argv),), backend=backend, rendezvous_dir=rendezvous_dir)
    return None


def env_ranks() -> Optional[Tuple[int, int]]:
    """(rank, world) where a launcher such as torchrun set RANK and
    WORLD_SIZE (and MASTER_ADDR / MASTER_PORT for `env://`), else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


def _rank_main(rank: int, fn: Callable, world: int, backend: str, init_method: str, args: Sequence) -> None:
    mesh.init_process_group(backend, rank, world, init_method)
    try:
        fn(*args)
    finally:
        mesh.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), *, backend: str, rendezvous_dir: str,
          timeout_s: Optional[float] = None) -> None:
    """Run `fn(*args)` on `world` ranks, each in a process of its own started
    with the `spawn` context (`fn` must be importable by name), joined in a
    process group of `backend`. Returns when every rank returned; raises
    (after stopping the others) when a rank raises or exits non-zero, or when
    `timeout_s` passes first."""
    os.makedirs(rendezvous_dir, exist_ok=True)
    store = os.path.join(os.path.abspath(rendezvous_dir), f".rendezvous-{uuid.uuid4().hex}")
    ctx = mp.start_processes(_rank_main, args=(fn, world, backend, f"file://{store}", tuple(args)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):  # raises when a rank failed, after stopping the others
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        # the rendezvous, and the files in which a failing rank left its traceback
        for path in (store, *ctx.error_files):
            if os.path.exists(path):
                os.remove(path)
