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

`sample_texture` and `resolve_diffuse` are the JAX package's exact
full-resolution sampler (`nrenderer_tpu/ops/texture.py:21-51`), which the
hybrid mesh route's wavefront uses, as the XLA route does."""
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


def sample_texture(tex: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> V3:
    """Nearest texel of an (H, W, 3) texture at (u, v): u and v wrap when
    outside [0, 1], v = 0 is the image's bottom row, and the boundary texel
    is clamped (u = 1 is the last column, not the first)."""
    h, w = tex.shape[0], tex.shape[1]
    u = torch.where((u < 0.0) | (u > 1.0), u - torch.floor(u), u)
    v = torch.where((v < 0.0) | (v > 1.0), v - torch.floor(v), v)
    x = torch.clamp(torch.floor(u * w).to(torch.int32), 0, w - 1)
    y = torch.clamp(torch.floor((1.0 - v) * h).to(torch.int32), 0, h - 1)
    flat = tex.reshape(-1, 3)
    idx = (y * w + x).long()
    return V3(flat[idx, 0], flat[idx, 1], flat[idx, 2])


def resolve_diffuse(textures, uv, diffuse: V3) -> V3:
    """`diffuse` with the texel of the hit's texture where the hit carries
    a texture id (within 0.5 of a texture's index).  `textures`: a tuple of
    (H, W, 3) tensors on the rays' device; `uv`: (u, v, texture id)."""
    if not textures or uv is None:
        return diffuse
    tu, tv, tid = uv
    out = diffuse
    for i, tex in enumerate(textures):
        out = where3((tid > i - 0.5) & (tid < i + 0.5),
                     sample_texture(tex, tu, tv), out)
    return out
