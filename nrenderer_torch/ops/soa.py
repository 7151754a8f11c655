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
