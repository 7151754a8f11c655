"""Environment-map lookups on torch tensors.

Counterpart of `nrenderer_tpu/ops/env.py` (equirectangular lookup by ray
direction, +y to the top row, phi = atan2(z, x)) and of the index math the
Pallas kernel uses for it (`nrenderer_tpu/ops/pt_pallas.py`):

  - `sample_env_map_v3`, the exact lookup (atan2/asin);
  - `bin_env_map`, the mean-pooled (3, rows, 128) bin table (numpy);
  - `atan2_approx`/`asin_approx`, the kernel's polynomial angles, and from
    them `env_bin_index` (the binned table's row and column after the
    bounce loop) and `env_native_index` (the native-resolution texel of a
    bounce-0 miss).

The CUDA kernel (`csrc/pt_kernel.cu`) repeats the polynomial index math in
the same float32 order."""
from __future__ import annotations

import numpy as np
import torch

from .soa import V3, normalize3

PI = 3.14159265358979323846

ENV_ROWS = 32    # binned env table: ENV_ROWS x ENV_LANES bins
ENV_LANES = 128

_HALF_PI = float(np.float32(0.5 * PI))
_PI32 = float(np.float32(PI))
_INV_2PI = float(np.float32(0.5 / PI))
_INV_PI = float(np.float32(1.0 / PI))


def sample_env_map_v3(env: torch.Tensor, d: V3) -> V3:
    """Exact equirect lookup: env (He, We, 3), d a V3 of (N,) directions;
    returns V3 radiance."""
    he, we = env.shape[0], env.shape[1]
    dn = normalize3(d, eps=1e-12)
    u = 0.5 + torch.atan2(dn.z, dn.x) / (2.0 * PI)
    v = 0.5 - torch.asin(torch.clamp(dn.y, -1.0, 1.0)) / PI
    x = torch.clamp((u * we).to(torch.int64), 0, we - 1)
    y = torch.clamp((v * he).to(torch.int64), 0, he - 1)
    flat = env.reshape(-1, 3)[y * we + x]
    return V3(flat[:, 0], flat[:, 1], flat[:, 2])


def bin_env_map(env, rows: int = ENV_ROWS, lanes: int = ENV_LANES
                ) -> np.ndarray:
    """Downsample an equirect env map to a (3, rows, lanes) float32 table:
    texel (y, x) lands in bin (y*rows//He, x*lanes//We) and each bin holds
    the mean of its texels (an empty bin holds 0).  A map already
    (rows, lanes) comes back unchanged."""
    e = np.asarray(env, np.float32)
    he, we = e.shape[0], e.shape[1]
    ys = (np.arange(he) * rows) // he
    xs = (np.arange(we) * lanes) // we
    flat = ys[:, None] * lanes + xs[None, :]
    acc = np.zeros((rows * lanes, 3), np.float64)
    cnt = np.zeros((rows * lanes,), np.int64)
    np.add.at(acc, flat.reshape(-1), e.reshape(-1, 3))
    np.add.at(cnt, flat.reshape(-1), 1)
    acc /= np.maximum(cnt, 1)[:, None]
    return np.ascontiguousarray(
        acc.reshape(rows, lanes, 3).transpose(2, 0, 1).astype(np.float32))


def atan2_approx(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's polynomial atan2 (`pt_pallas._atan2_approx`;
    max error ~1e-5 rad), float32, in its operation order."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    a = mn / torch.clamp(mx, min=1e-30)
    s = a * a
    r = a * (0.99997726 + s * (-0.33262347 + s * (0.19354346 + s * (
        -0.11643287 + s * (0.05265332 - 0.01172120 * s)))))
    r = torch.where(ay > ax, _HALF_PI - r, r)
    r = torch.where(x < 0.0, _PI32 - r, r)
    return torch.where(y < 0.0, -r, r)


def asin_approx(y: torch.Tensor) -> torch.Tensor:
    """asin via atan2_approx(y, sqrt(1 - y^2)); y pre-clipped to [-1, 1]."""
    return atan2_approx(y, torch.sqrt(torch.clamp(1.0 - y * y, min=0.0)))


def _env_uv(d: V3):
    u = 0.5 + atan2_approx(d.z, d.x) * _INV_2PI
    v = 0.5 - asin_approx(torch.clamp(d.y, -1.0, 1.0)) * _INV_PI
    return u, v


def env_bin_index(d: V3, rows: int = ENV_ROWS, lanes: int = ENV_LANES):
    """(row, col) int64 of the binned table for unit directions `d`."""
    u, v = _env_uv(d)
    col = torch.clamp((u * lanes).to(torch.int32), 0, lanes - 1)
    row = torch.clamp((v * rows).to(torch.int32), 0, rows - 1)
    return row.long(), col.long()


def env_native_index(d: V3, he: int, we: int):
    """(y, x) int64 native texel for unit directions `d`, with the kernel's
    polynomial angles."""
    u, v = _env_uv(d)
    x = torch.clamp((u * we).to(torch.int32), 0, we - 1)
    y = torch.clamp((v * he).to(torch.int32), 0, he - 1)
    return y.long(), x.long()


def env_bin_lookup(table: torch.Tensor, d: V3) -> V3:
    """Binned lookup: `table` (3, rows, lanes) float32, d a V3."""
    row, col = env_bin_index(d, table.shape[1], table.shape[2])
    return V3(table[0][row, col], table[1][row, col], table[2][row, col])


def env_native_lookup(env: torch.Tensor, d: V3) -> V3:
    """Native-resolution lookup: `env` (He, We, 3) float32, d a V3."""
    y, x = env_native_index(d, env.shape[0], env.shape[1])
    px = env[y, x]
    return V3(px[:, 0], px[:, 1], px[:, 2])
