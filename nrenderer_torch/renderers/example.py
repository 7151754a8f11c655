"""Example renderer — the tutorial/smoke-test plugin.

Rebuild of `components/example/src/Adapter.cpp:11-39`: sleeps briefly, fills a
UV gradient image, and exercises all four log levels.  Doubles as a smoke test
of the registry + executor pipeline, as in the reference.  A copy of
`nrenderer_tpu/renderers/example.py`, which has no JAX in it."""
from __future__ import annotations

import time

import numpy as np

from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer


@register_renderer("Example", description="A example renderer.")
class ExampleRenderer(RenderComponent):
    def render(self, scene: Scene) -> RenderResult:
        logger = get_server().logger
        logger.log("Example log...")
        logger.warning("Example warning...")
        logger.error("Example error...")
        logger.success("Example success...")
        time.sleep(1.0)
        w, h = scene.render_option.width, scene.render_option.height
        j = np.arange(w, dtype=np.float32)[None, :, None]
        i = np.arange(h, dtype=np.float32)[:, None, None]
        pixels = np.concatenate([
            np.broadcast_to(j / w, (h, w, 1)),
            np.broadcast_to(i / h, (h, w, 1)),
            np.full((h, w, 1), 0.2, np.float32),
            np.ones((h, w, 1), np.float32),
        ], axis=2)
        return RenderResult(pixels=pixels[::-1], width=w, height=h)
