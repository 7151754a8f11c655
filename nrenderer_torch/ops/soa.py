"""Component-SoA vector math on torch tensors.

Counterpart of `nrenderer_tpu/ops/soa.py`: a ray batch keeps each vector
component as its own `(N,)` tensor, and `V3` is a NamedTuple of three
same-shaped tensors.  The helpers are plain elementwise torch ops written in
the same operation order as the JAX module, so float32 results agree."""
from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def dot3(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross3(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def norm3(a: V3) -> torch.Tensor:
    return torch.sqrt(dot3(a, a))


def normalize3(a: V3, eps: float = 0.0) -> V3:
    n2 = dot3(a, a)
    if eps:
        # same floor as the JAX module: eps^2 may be subnormal
        n2 = torch.clamp(n2, min=max(eps * eps, 1.2e-38))
    inv = torch.rsqrt(n2)
    return V3(a.x * inv, a.y * inv, a.z * inv)


def where3(cond: torch.Tensor, a: V3, b: V3) -> V3:
    return V3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
              torch.where(cond, a.z, b.z))


def v3(x, y, z) -> V3:
    return V3(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(z))


def splat(arr) -> V3:
    """From a length-3 (or (..., 3)) tensor: components along the last
    axis."""
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])


def to_array(v: V3) -> torch.Tensor:
    """Back to (..., 3) (film assembly only)."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def reflect3(d: V3, n: V3) -> V3:
    """d - 2*dot(d,n)*n (`vec.hpp:57-59`)."""
    k = 2.0 * dot3(d, n)
    return V3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def lerp3(a: V3, b: V3, t) -> V3:
    return V3(a.x + (b.x - a.x) * t, a.y + (b.y - a.y) * t,
              a.z + (b.z - a.z) * t)


def select_prim(one_hot: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """`one_hot` (P, N) float mask with at most one 1 per column, `table`
    (P,) per-primitive attribute -> (N,) selected values (0 where the
    column has no 1)."""
    return torch.sum(one_hot * table[:, None], dim=0)


def select_prim3(one_hot: torch.Tensor, table: V3) -> V3:
    return V3(select_prim(one_hot, table.x), select_prim(one_hot, table.y),
              select_prim(one_hot, table.z))


def one_hot_argmin(t: torch.Tensor) -> torch.Tensor:
    """(P, N) -> (P, N) float one-hot of the per-column argmin; on ties the
    first index wins, as `torch.argmin` documents and `jnp.argmin` does."""
    idx = torch.argmin(t, dim=0)
    iota = torch.arange(t.shape[0], dtype=idx.dtype, device=t.device)
    return (iota[:, None] == idx[None, :]).to(t.dtype)
