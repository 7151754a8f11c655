"""RenderComponent base class — the renderer plugin ABI.

Rebuild of `Instance` -> `Component` -> `RenderComponent`
(`code/include/component/RenderComponent.hpp:12-18`,
`code/server/component/RenderComponent.cpp:5-9`): subclasses implement
`render(scene) -> RenderResult`; `exec(on_start, on_finish, scene)` wraps it
with lifecycle callbacks and posts the image to the shared Screen (which the
reference adapters do explicitly, e.g.
`simple_path_tracing/src/Adapter.cpp:15-21`)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..scene.model import Scene
from .registry import get_server


@dataclass
class RenderResult:
    """(pixels, width, height) tuple of the reference renderers."""
    pixels: np.ndarray  # (H, W, 4) float32, row 0 = TOP of image
    width: int
    height: int


class RenderComponent:
    component_info = None  # filled by @register_renderer

    def render(self, scene: Scene) -> RenderResult:  # pragma: no cover
        raise NotImplementedError

    def exec(self, on_start: Optional[Callable], on_finish: Optional[Callable],
             scene: Scene) -> RenderResult:
        if on_start:
            on_start()
        result = self.render(scene)
        if result is not None:
            get_server().screen.set(result.pixels, result.width, result.height)
        if on_finish:
            on_finish()
        return result
