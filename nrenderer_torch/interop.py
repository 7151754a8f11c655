"""Hand the JAX package's scene and camera state to the port.

The renderer has no weights: its state is the scene (`StaticScene`) and the
camera (`CameraParams`).  The JAX package's `StaticScene` already holds numpy
arrays and Python numbers, and its `CameraParams` arrays convert with
`np.asarray`, so both sides can be fed one scene and one camera: a kernel
difference is then never a parser difference.  Nothing here imports JAX; the
functions read fields by name from any object that has them."""
from __future__ import annotations

import numpy as np
import torch

from .ops.camera import CameraParams
from .ops.intersect import StaticScene


def static_scene_from_numpy(src) -> StaticScene:
    """A port `StaticScene` from an object with `StaticScene`'s fields
    (e.g. `nrenderer_tpu.ops.intersect.StaticScene`)."""
    arr = lambda x: np.array(x, copy=True)
    return StaticScene(
        sph=[(float(cx), float(cy), float(cz), float(r), int(m))
             for (cx, cy, cz, r, m) in src.sph],
        tri=[(arr(v1), arr(e1), arr(e2), arr(n), int(m))
             for (v1, e1, e2, n, m) in src.tri],
        pln=[(arr(p), arr(n), arr(i0), arr(i1), int(m))
             for (p, n, i0, i1, m) in src.pln],
        al=[(arr(p), arr(n), arr(i0), arr(i1), arr(r))
            for (p, n, i0, i1, r) in src.al],
        mats=[{k: (arr(v) if isinstance(v, np.ndarray) else v)
               for k, v in m.items()} for m in src.mats],
        ambient_type=int(src.ambient_type),
        ambient_constant=tuple(src.ambient_constant),
        n_mats=int(src.n_mats),
        tri_uv=tuple(src.tri_uv),
    )


def camera_from_numpy(src, *, device) -> CameraParams:
    """A port `CameraParams` (float32 tensors on `device`) from an object
    with `CameraParams`' fields (e.g. `nrenderer_tpu.ops.camera`'s)."""
    return CameraParams(*(
        torch.as_tensor(np.array(getattr(src, name), np.float32),
                        device=device)
        for name in CameraParams._fields))
