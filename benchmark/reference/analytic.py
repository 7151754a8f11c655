"""The reference of analytic scenes (spheres, triangles, planes, area
lights, a constant ambient) under the contract of `reference/__init__.py`:
`scene`'s tables of the configuration's `.scn` file, rendered by `tracer`
from the renderer's default camera; the configuration's `estimator`
("diffuse" or "bsdf") picks the estimator."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from reference import scene, tracer


def load(config: dict, root: Path) -> scene.Tables:
    return scene.load_tables(str(Path(root) / config["scene"]))


def counts(tables: scene.Tables) -> dict:
    return scene.primitive_counts(tables)


def table_floats(tables: scene.Tables) -> int:
    return scene.table_floats(tables)


def render_pixels(tables: scene.Tables, config: dict, traffic: dict, ids,
                  seed: int, device, dtype=torch.float32,
                  stats: dict = None) -> np.ndarray:
    return tracer.render_pixels(
        tables, scene.default_camera(), ids, traffic["width"],
        traffic["height"], traffic["spp"], traffic["depth"], seed,
        config["estimator"] == "bsdf", dtype=dtype, device=device,
        stats=stats)
