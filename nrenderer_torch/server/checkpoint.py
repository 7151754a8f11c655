"""Render checkpoint / resume.

A copy of `nrenderer_tpu/server/checkpoint.py` (it imports no JAX; the port
keeps its own copy).  `camera_key` reads torch tensors as well.

The reference has NO checkpointing: renders are all-or-nothing with the film
posted once at the end (SURVEY.md §5.4).  The rebuild checkpoints the linear
film accumulator + the sample counter + the PRNG position, so an interrupted
render resumes exactly where it stopped (same estimator: the film is a sum of
independent per-chunk estimates keyed by chunk index).

Format: a single .npz with {film (n_pix, 3) f32 linear sums, spp_done,
width, height, seed, fingerprint} — the fingerprint guards against resuming
onto a different scene/config.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def render_fingerprint(parts, arrays=()) -> str:
    """Resume-compatibility fingerprint shared by every checkpointing
    renderer (review r3: two hand-rolled copies had diverged, and both
    omitted the camera).

    `parts`: static render config — StaticScene, the camera basis as plain
    floats, film shape, spp/depth/seed/chunking, engine choices.  Everything
    that changes the film estimator MUST be in here, or a resume after
    changing it silently blends two different renders into one film.
    `arrays`: pixel payloads (env map, texture images) — content-bearing but
    too large for repr, so their raw bytes are hashed.
    """
    import hashlib
    h = hashlib.sha1(repr(parts).encode())
    for a in arrays:
        a = np.asarray(a)
        h.update(repr((a.shape, str(a.dtype))).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def camera_key(cam) -> tuple:
    """CameraParams -> nested tuple of plain floats for render_fingerprint
    (device-array reprs are backend-dependent; float tuples are not)."""
    return tuple(tuple(np.asarray(_host(x), np.float64).ravel().tolist())
                 for x in cam)


def _host(x):
    """A torch tensor as numpy on the host; anything else unchanged."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def save_checkpoint(path: str, film: np.ndarray, spp_done: int, width: int,
                    height: int, seed: int, fingerprint: str) -> None:
    tmp = path + ".tmp"
    np.savez(tmp if not tmp.endswith(".npz") else tmp,
             film=np.asarray(film, np.float32),
             spp_done=np.int64(spp_done), width=np.int64(width),
             height=np.int64(height), seed=np.int64(seed),
             fingerprint=np.bytes_(fingerprint.encode()))
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def load_checkpoint(path: str, fingerprint: str
                    ) -> Optional[Tuple[np.ndarray, int]]:
    """Returns (film, spp_done) if the checkpoint exists and matches the
    scene/config fingerprint; None otherwise."""
    if not os.path.exists(path):
        return None
    try:
        data = np.load(path)
    except (OSError, ValueError):
        return None
    stored = bytes(data["fingerprint"]).decode(errors="replace")
    if stored != fingerprint:
        return None
    return np.asarray(data["film"], np.float32), int(data["spp_done"])
