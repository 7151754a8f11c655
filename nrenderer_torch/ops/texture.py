"""Binned surface textures, as the path-tracing kernel reads them.

Counterpart of the texture half of `nrenderer_tpu/ops/pt_pallas.py`:
`_tex_tabs` (`:446`) bins each (H, W, 3) texture to a (3, TEX_ROWS, 128)
table, and `_make_tex_resolver` (`:96-120`) looks a hit's (u, v, texture
id) up in it: u and v wrap when outside [0, 1], column int(u * 128) and
row int((1 - v) * TEX_ROWS), both clipped (v = 0 is the image's bottom
row), and the texture whose index is within 0.5 of the id replaces the
colour.  `tex_tables` and `make_tex_resolver` are the plain form; the CUDA
kernel (`csrc/pt_kernel.cu`, `tex_lookup`) indexes the same tables with the
same float32 math.

The JAX package's exact full-resolution sampler (`ops/texture.py`, the XLA
wavefront's) is not ported: the kernel route uses the binned tables."""
from __future__ import annotations

import numpy as np
import torch

from .env import bin_env_map
from .soa import V3, where3

TEX_ROWS = 32    # binned surface textures: TEX_ROWS x TEX_LANES texels
TEX_LANES = 128


def tex_tables(textures) -> np.ndarray:
    """(n_tex, 3, TEX_ROWS, TEX_LANES) float32 tables of (H, W, 3)
    textures.  Sources at least table-sized are mean-pooled (exact at
    exactly that size); smaller ones are nearest-sampled at bin centres."""
    tabs = []
    for tex in textures:
        e = np.asarray(tex, np.float32)[..., :3]
        h, w = e.shape[0], e.shape[1]
        if h >= TEX_ROWS and w >= TEX_LANES:
            t = bin_env_map(e, rows=TEX_ROWS, lanes=TEX_LANES)
        else:
            ys = np.clip(((np.arange(TEX_ROWS) + 0.5) * h
                          / TEX_ROWS).astype(np.int64), 0, h - 1)
            xs = np.clip(((np.arange(TEX_LANES) + 0.5) * w
                          / TEX_LANES).astype(np.int64), 0, w - 1)
            t = e[ys[:, None], xs[None, :]].transpose(2, 0, 1)
        tabs.append(np.asarray(t, np.float32))
    return np.ascontiguousarray(
        np.stack(tabs) if tabs
        else np.zeros((0, 3, TEX_ROWS, TEX_LANES), np.float32))


def tex_index(tu: torch.Tensor, tv: torch.Tensor):
    """(row, col) int64 of the binned texel at (u, v)."""
    u = torch.where((tu < 0.0) | (tu > 1.0), tu - torch.floor(tu), tu)
    v = torch.where((tv < 0.0) | (tv > 1.0), tv - torch.floor(tv), tv)
    col = torch.clamp((u * TEX_LANES).to(torch.int32), 0, TEX_LANES - 1)
    row = torch.clamp(((1.0 - v) * TEX_ROWS).to(torch.int32), 0,
                      TEX_ROWS - 1)
    return row.long(), col.long()


def make_tex_resolver(tables: torch.Tensor):
    """`resolve(uv, colour) -> V3`: `uv` = (u, v, texture id) per ray; the
    colour where the id names a texture is replaced by its texel."""
    n_tex = tables.shape[0]
    flat = tables.reshape(n_tex, 3, -1)

    def resolve(uv, colour: V3) -> V3:
        tu, tv, tid = uv
        row, col = tex_index(tu, tv)
        lin = row * TEX_LANES + col
        out = colour
        for i in range(n_tex):
            texel = V3(flat[i, 0][lin], flat[i, 1][lin], flat[i, 2][lin])
            out = where3((tid > i - 0.5) & (tid < i + 0.5), texel, out)
        return out

    return resolve
