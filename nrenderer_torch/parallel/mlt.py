"""Chain-sharded MLT: the Markov chains split across devices.

Counterpart of `nrenderer_tpu/parallel/mlt.py` (`render_mlt_sharded :40`).
Rank r of N owns the global chains [r*C/N, (r+1)*C/N) and runs the
one-device render loop's pieces on them (`renderers/mlt.py`):

- every draw is `hash(chain, step, draw, seed')` of the GLOBAL chain
  (`state_uniforms`/`mutation_step` with the rank's chain offset), so rank
  r's chains move exactly as those chains move in a one-device render
  (JAX folds the device index into its `jax.random` key instead);
- the brightness estimate b is one `all_reduce` of the ranks' sums of the
  init samples' contributions;
- each rank splats into a film of its own; one `all_reduce` of the films
  follows at the flush, and rank 0 tone-maps.

So a world of one is the one-device render bit for bit, and a world of N
moves every chain as one device does; the film differs by the order of
the final sum and b by the order of its sum (b scales the splat weights,
not the acceptance).  With a checkpoint path rank 0 gathers the chain
carry, the ranks' films and b after each block and writes one file whose
fingerprint holds the world size; a resume gives every rank its slice, and
ends bit-identical to a straight run with the same world size.  Mesh
scenes run the mesh pipe (B2, or B4 under NR_MESH_MXU=1) on every rank."""
from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .group import (
    DEFAULT_TIMEOUT_S, Rank, all_reduce_sum, broadcast_value, check_devices,
    gather_rows, launch,
)
from .mesh import ShardedRender, reset_launch_counts, summed_launches


def _carry(ch) -> list:
    return [ch.u, *ch.contribs, ch.sc, ch.w_acc]


def _save(path: str, film: torch.Tensor, carry: list, b: float,
          blocks_done: int, fingerprint: str) -> None:
    """Atomic snapshot: the ranks' films (N, cap + 1, 3), the chain carry
    in global chain order, b and the blocks done."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, b=np.float64(b), blocks_done=np.int64(blocks_done),
             fingerprint=np.bytes_(fingerprint.encode()),
             film=film.cpu().numpy(),
             **{f"leaf_{i}": t.cpu().numpy() for i, t in enumerate(carry)})
    os.replace(tmp, path)


def _gather_carry(rank: Rank, ch) -> Optional[tuple]:
    """(films, carry) with the chains in global order, on rank 0."""
    film = gather_rows(ch.film[None], rank)
    # the chain axis is the last one: gather along it as rows (bool
    # leaves as bytes, which every backend takes)
    leaves = _carry(ch)
    carry = [gather_rows(t.movedim(-1, 0).to(
        torch.uint8 if t.dtype == torch.bool else t.dtype).contiguous(),
        rank) for t in leaves]
    if rank.rank != 0:
        return None
    return film, [c.movedim(0, -1).to(t.dtype).contiguous()
                  for c, t in zip(carry, leaves)]


def _load_slice(path: str, rank: Rank, c0: int, c_loc: int, device):
    """This rank's film and chains from the snapshot at `path`."""
    from ..renderers.mlt import _Chains
    data = np.load(path)
    leaves = [torch.as_tensor(data[f"leaf_{i}"][..., c0:c0 + c_loc].copy(),
                              device=device) for i in range(9)]
    film = torch.as_tensor(data["film"][rank.rank], device=device)
    return _Chains(film=film, u=leaves[0], contribs=tuple(leaves[1:7]),
                   sc=leaves[7], w_acc=leaves[8])


def _flush_all(rank: Rank, ch, width: int, height: int):
    """The films of every rank with their current states splatted, summed
    (H, W, 3) on rank 0; None elsewhere."""
    from ..renderers.mlt import _splat
    film = ch.film.clone()
    _splat(film, ch.contribs, ch.w_acc, width, height)
    film = all_reduce_sum(film, rank)
    if rank.rank != 0:
        return None
    return film[:width * height].cpu().numpy().reshape(height, width, 3)


def _mlt_rank(rank: Rank, scene, chains: int, mutations: int, n_init: int,
              seed: int, max_path: Optional[int],
              checkpoint_path: Optional[str], block_limit: Optional[int]):
    """The chain-sharded render on one rank (see the module doc)."""
    from ..ops import mesh_mxu
    from ..renderers import mlt
    t0 = time.perf_counter()
    reset_launch_counts()
    dev = rank.device
    prep = mlt._prepare_mlt(scene, dev, max_path)
    if prep is None:
        ro = scene.render_option
        img = np.zeros((ro.height, ro.width, 4), np.float32)
        return ShardedRender(img, None, 0, "mlt", {}, {}, rank.backend)
    kern, width, height = prep
    ns = kern.n_states
    c_loc = chains // rank.world
    c0 = rank.rank * c_loc
    cap = mlt.film_bucket(width * height)
    block = min(mutations, int(os.environ.get("NR_MLT_BLOCK", "128")))
    n_blocks = max(1, mutations // block)
    wh = (float(width), float(height))
    fingerprint = hashlib.sha1(repr(
        ("sharded", rank.world, kern.ss, kern.cam, kern.max_path,
         kern.emitted, kern.light_pos, kern.light_u, kern.light_v,
         kern.tri_bvh is not None, mesh_mxu.enabled(), chains, n_init,
         block, cap, width, height, mutations, seed)).encode()).hexdigest()
    start = -1
    if rank.rank == 0 and checkpoint_path and os.path.exists(
            checkpoint_path):
        try:
            data = np.load(checkpoint_path)
            if bytes(data["fingerprint"]).decode(errors="replace") \
                    == fingerprint:
                start = int(data["blocks_done"])
                b = float(data["b"])
                from ..server.registry import get_server
                get_server().logger.log(
                    f"MLT: resumed at block {start}/{n_blocks} on "
                    f"{rank.world} ranks from {checkpoint_path}")
        except (OSError, ValueError, KeyError):
            start = -1
    start = broadcast_value(start, rank)
    seconds = {}
    if start >= 0:
        b = broadcast_value(b if rank.rank == 0 else None, rank)
        ch = _load_slice(checkpoint_path, rank, c0, c_loc, dev)
    else:
        start = 0
        t1 = time.perf_counter()
        steps = max(1, n_init // chains)
        total = 0.0
        for i in range(steps):
            u = mlt.state_uniforms(ns, c_loc, i, 0,
                                   mlt.bounce_seed(seed, mlt.SEED_B), dev,
                                   c0)
            total += float(kern.sample(u, wh)[1].sum())
        total = float(all_reduce_sum(torch.tensor(
            [total], dtype=torch.float64, device=dev), rank)[0])
        b = total / (steps * chains)
        seconds["b-estimate"] = time.perf_counter() - t1
        if not np.isfinite(b) or b <= 0:
            return (ShardedRender(np.zeros((height, width, 4), np.float32),
                                  None, 0, "mlt", {}, seconds, rank.backend)
                    if rank.rank == 0 else None)
        u = mlt.state_uniforms(ns, c_loc, 0, 0,
                               mlt.bounce_seed(seed, mlt.SEED_INIT), dev, c0)
        contribs, sc = kern.sample(u, wh)
        ch = mlt._Chains(film=torch.zeros((cap + 1, 3), device=dev), u=u,
                         contribs=contribs, sc=sc,
                         w_acc=torch.zeros((c_loc,), device=dev))
    preview_every = int(os.environ.get("NR_MLT_PREVIEW_BLOCKS", "0"))
    m_seed = mlt.bounce_seed(seed, mlt.SEED_MUTATE)
    stop = n_blocks if block_limit is None else min(n_blocks,
                                                    start + block_limit)
    t1 = time.perf_counter()
    for i in range(start, stop):
        for j in range(block):
            ch = mlt.mutation_step(kern, ch, i * block + j, b, m_seed, c0)
        if checkpoint_path:
            got = _gather_carry(rank, ch)
            if got is not None:
                _save(checkpoint_path, got[0], got[1], b, i + 1,
                      fingerprint)
        if (preview_every > 0 and i + 1 < n_blocks
                and (i + 1 - start) % preview_every == 0):
            part = _flush_all(rank, ch, width, height)
            if part is not None:
                rank.post("preview", (i + 1) * block, mlt.tonemap(
                    part, width, height, chains, (i + 1) * block))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds["mutate"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    film = _flush_all(rank, ch, width, height)
    seconds["collective"] = time.perf_counter() - t1
    launches = summed_launches(rank)
    if rank.rank != 0:
        return None
    seconds["total"] = time.perf_counter() - t0
    img = (mlt.tonemap(film, width, height, chains, n_blocks * block)
           if stop == n_blocks else None)
    return ShardedRender(img, film, stop * block, "mlt", launches, seconds,
                         rank.backend)


def render_mlt_sharded(scene, devices: Sequence, chains: int = 1024,
                       mutations: int = 256, n_init: int = 10000,
                       seed: int = 0, max_path: Optional[int] = None,
                       checkpoint_path: Optional[str] = None,
                       screen=None, on_preview: Optional[Callable] = None,
                       block_limit: Optional[int] = None,
                       timeout: float = DEFAULT_TIMEOUT_S,
                       threads: Optional[int] = None) -> ShardedRender:
    """Chain-sharded MLT render over one rank per entry of `devices`; the
    result's image is `renderers.mlt.render_mlt`'s (H, W, 4) RGBA, row 0 =
    top, and its film the (H, W, 3) splat sums (`mutations` per chain in
    `spp_done`).  `chains` is the TOTAL chain count and must divide by the
    device count.  `checkpoint_path`: save the chains after each block and
    resume a matching snapshot; `block_limit`: stop after that many blocks
    of this call (the image is then None).  NR_MLT_PREVIEW_BLOCKS = k
    posts the partial film to `screen` / `on_preview` every k blocks."""
    devs = check_devices(devices)
    if chains < 1 or chains % len(devs):
        raise ValueError(f"MLT shards its chains: --chains ({chains}) must "
                         f"be a multiple of the device count {len(devs)}")

    def on_message(rank, kind, done, rgba):
        if screen is not None:
            screen.set(rgba, rgba.shape[1], rgba.shape[0])
        if on_preview is not None:
            on_preview(done, rgba)

    return launch(_mlt_rank, devs, scene, chains, mutations, n_init, seed,
                  max_path, checkpoint_path, block_limit, timeout=timeout,
                  threads=threads, on_message=on_message)
