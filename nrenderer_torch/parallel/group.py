"""Rank groups over `torch.distributed`: the port's `make_mesh`.

The JAX package shards a render over a 1-D `jax.sharding.Mesh` inside one
process (`nrenderer_tpu/parallel/mesh.py:34`).  The port runs one process
per device instead: `launch(fn, devices, ...)` spawns a rank for every
entry of an explicit device list (`torch.multiprocessing`, the `spawn`
start method), joins them into one process group through a file
rendezvous in a fresh temporary directory (so concurrent launches never
share a port), calls `fn(rank, *args)` on every rank and returns what
rank 0 returned.

- The backend is NCCL when every rank has a CUDA device of its own, gloo
  when a device repeats (two ranks sharing one GPU) or the devices are the
  CPU.  `all_reduce_sum` and `gather_rows` stage CUDA tensors through the
  host under gloo.
- A world larger than the devices there are is refused, as `make_mesh`
  refuses it: nothing is truncated, and `cuda` never falls back to the
  CPU.
- The parent supervises: a rank that raises or dies makes the launch raise
  (the other ranks are stopped), and so does a launch that outlives its
  `timeout`, so a hung rendezvous fails instead of hanging its caller.
- The parent builds the CUDA kernel library before it spawns a CUDA rank,
  so the ranks load it instead of compiling it each.
- Rank 0 may `post` messages (previews) to the parent while it runs; the
  launch hands each to `on_message` in the parent, in order.

The rank functions live in this package, so a rank imports torch and
`nrenderer_torch` only.  Each CPU rank runs `threads` torch threads (by
default the CPU count shared among the ranks, at most 4): the plain
versions sum each pixel's samples in order, so the result does not depend
on it."""
from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 900.0


class RankError(RuntimeError):
    """A rank of a launch raised, died or timed out."""


class Rank(NamedTuple):
    """What a rank function is told about itself."""
    rank: int
    world: int
    device: torch.device
    devices: tuple          # every rank's device, as strings
    backend: str            # "nccl" or "gloo"
    outbox: object          # the queue `post` writes to

    def post(self, *message) -> None:
        """Send a message to the launching process (`on_message`)."""
        self.outbox.put(("message", self.rank, message))


def available_devices(device_type: str) -> int:
    """How many devices of a type a launch may use: the CUDA device count,
    or the CPU count for CPU ranks."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type == "cpu":
        return os.cpu_count() or 1
    raise ValueError(f"unsupported device type {device_type!r}: use "
                     "'cuda' or 'cpu'")


def make_devices(n: int, device_type: str = "cuda") -> List[torch.device]:
    """The first `n` devices of a type (`cuda:0` ... or `n` CPU ranks);
    raises when fewer are available, as `make_mesh` does
    (`nrenderer_tpu/parallel/mesh.py:41-47`)."""
    have = available_devices(device_type)
    if n < 1 or n > have:
        raise ValueError(
            f"{n} {device_type} devices requested, {have} available; "
            "refusing to truncate to a smaller world")
    if device_type == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", i) for i in range(n)]


def check_devices(devices: Sequence) -> List[torch.device]:
    """`devices` as torch.devices, every one present on this machine."""
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a launch needs at least one device")
    for d in devs:
        if d.type == "cuda":
            have = available_devices("cuda")
            if have == 0:
                raise RuntimeError(
                    f"device {d} requested but torch.cuda.is_available() is "
                    "False: no GPU to run the ranks on")
            index = 0 if d.index is None else d.index
            if index >= have:
                raise ValueError(f"device {d} requested, {have} CUDA "
                                 "devices available")
        elif d.type != "cpu":
            raise ValueError(f"unsupported device {d}: use 'cuda' or 'cpu'")
    if len({d.type for d in devs}) != 1:
        raise ValueError("a launch's devices must be all CUDA or all CPU")
    return [torch.device("cuda", d.index or 0) if d.type == "cuda" else d
            for d in devs]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    cuda = all(d.type == "cuda" for d in devices)
    return "nccl" if cuda and len(set(devices)) == len(devices) else "gloo"


def _staged(t: torch.Tensor, rank: Rank) -> bool:
    return rank.backend == "gloo" and t.device.type == "cuda"


def all_reduce_sum(t: torch.Tensor, rank: Rank) -> torch.Tensor:
    """Sum `t` over the ranks, in place; returns it (a world of one runs
    the collective too, which leaves `t` as it is)."""
    if _staged(t, rank):
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def gather_rows(t: torch.Tensor, rank: Rank) -> Optional[torch.Tensor]:
    """The ranks' equal-shaped `t` concatenated along dim 0 in rank order,
    on rank 0 (on its device); None on the others.  NCCL all-gathers on
    the group's communicator (its `gather` sets up point-to-point
    connections at first use, which costs far more than the transfer)."""
    if rank.backend == "nccl":
        out = torch.empty((rank.world * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.contiguous())
        return out if rank.rank == 0 else None
    src = t.cpu() if _staged(t, rank) else t.contiguous()
    parts = ([torch.empty_like(src) for _ in range(rank.world)]
             if rank.rank == 0 else None)
    dist.gather(src, gather_list=parts, dst=0)
    return None if parts is None else torch.cat(parts).to(t.device)


def barrier(rank: Rank) -> None:
    """Wait for every rank (on NCCL, on this rank's device)."""
    dist.barrier(**({"device_ids": [rank.device.index]}
                    if rank.backend == "nccl" else {}))


def broadcast_value(value, rank: Rank):
    """Rank 0's `value` (a picklable object) on every rank."""
    if rank.world == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def default_threads(world: int) -> int:
    return max(1, min(4, (os.cpu_count() or 1) // world))


def _rank_main(rank: int, devices: tuple, backend: str, init_file: str,
               timeout_s: float, threads: int, outbox, fn: Callable,
               args: tuple) -> None:
    """A spawned rank: join the group, run `fn`, report to the parent."""
    dev = torch.device(devices[rank])
    status = 0
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}",
            world_size=len(devices), rank=rank,
            timeout=timedelta(seconds=timeout_s))
        me = Rank(rank, len(devices), dev, devices, backend, outbox)
        # NCCL sets its communicator up at the first collective: a barrier
        # here keeps that out of the rank function's first collective
        barrier(me)
        result = fn(me, *args)
        outbox.put(("result", rank, result if rank == 0 else None))
    except BaseException:
        outbox.put(("error", rank, traceback.format_exc()))
        status = 1
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass
    if status:
        raise SystemExit(status)


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]   # the started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()


def launch(fn: Callable, devices: Sequence, *args,
           timeout: float = DEFAULT_TIMEOUT_S,
           threads: Optional[int] = None,
           on_message: Optional[Callable] = None):
    """Run `fn(rank, *args)` on one spawned rank per entry of `devices`
    and return rank 0's result.  `fn` and `args` must pickle (`fn` a
    module-level function).  Raises `RankError` when a rank raises or
    dies, or when the launch takes longer than `timeout` seconds (the
    rendezvous included); the other ranks are stopped first.  Messages a
    rank `post`s go to `on_message(rank, *message)` in this process."""
    devs = check_devices(devices)
    backend = backend_for(devs)
    if any(d.type == "cuda" for d in devs):
        from .._build import build
        build()
    threads = threads or default_threads(len(devs))
    ctx = torch.multiprocessing.get_context("spawn")
    outbox = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="nr_rdzv_")
    names = tuple(str(d) for d in devs)
    procs = [ctx.Process(
        target=_rank_main,
        args=(r, names, backend, os.path.join(tmp, "store"), timeout,
              threads, outbox, fn, args),
        daemon=True) for r in range(len(devs))]
    deadline = time.monotonic() + timeout
    result, done, failure = None, set(), None
    try:
        for p in procs:
            p.start()
        while len(done) < len(procs) and failure is None:
            try:
                kind, r, payload = outbox.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and not p.is_alive()]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} before it "
                               "reported")
                elif time.monotonic() > deadline:
                    failure = (f"launch on {list(names)} timed out after "
                               f"{timeout:.0f} s")
                continue
            if kind == "message":
                if on_message is not None:
                    on_message(r, *payload)
            elif kind == "error":
                failure = f"rank {r} on {names[r]} failed:\n{payload}"
            else:
                done.add(r)
                if r == 0:
                    result = payload
        if failure is None:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            late = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if late:
                failure = (f"rank {late[0]} did not exit cleanly (code "
                           f"{procs[late[0]].exitcode})")
    finally:
        _stop(procs)
        outbox.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RankError(failure)
    return result


def describe(rank: Rank) -> dict:
    """A rank's view of itself: its group, its device and whether JAX is
    loaded in its process (it must not be)."""
    import sys
    return {"rank": rank.rank, "world": rank.world,
            "device": str(rank.device), "backend": rank.backend,
            "jax_loaded": any(m == "jax" or m.startswith("jax.")
                              for m in sys.modules),
            "nrenderer_tpu_loaded": any(
                m.split(".")[0] == "nrenderer_tpu" for m in sys.modules)}


def _describe_all(rank: Rank) -> Optional[list]:
    """Every rank's `describe`, gathered on rank 0."""
    mine = describe(rank)
    if rank.world == 1:
        return [mine]
    out = [None] * rank.world if rank.rank == 0 else None
    dist.gather_object(mine, out, dst=0)
    return out


def describe_ranks(devices: Sequence, **launch_kw) -> list:
    """`describe` of every rank of a launch on `devices`."""
    return launch(_describe_all, devices, **launch_kw)
