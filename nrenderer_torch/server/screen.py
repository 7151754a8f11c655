"""Thread-safe shared framebuffer.

Rebuild of the reference `Screen` (`code/include/server/Screen.hpp:11-29`,
`code/server/server/Screen.cpp:7-66`): `set()` deep-copies and clamps every
pixel to [0,1] and raises a dirty flag; `get_pixels()` consumes the flag.
The renderer thread posts here; the UI/CLI thread polls `is_updated`."""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class Screen:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pixels: Optional[np.ndarray] = None  # (H, W, 4) float32
        self._updated = False

    def set(self, pixels: np.ndarray, width: int, height: int) -> None:
        """Store a clamped copy of an (H, W, 3|4) float image
        (`Screen.cpp:54-66`; clamp at `:63`)."""
        arr = np.asarray(pixels, dtype=np.float32).reshape(height, width, -1)
        if arr.shape[2] == 3:
            arr = np.concatenate(
                [arr, np.ones((height, width, 1), np.float32)], axis=2)
        arr = np.clip(arr, 0.0, 1.0)
        with self._lock:
            self._pixels = arr.copy()
            self._updated = True

    @property
    def is_updated(self) -> bool:
        with self._lock:
            return self._updated

    def get_pixels(self) -> Optional[np.ndarray]:
        """Return the buffer and clear the dirty flag."""
        with self._lock:
            self._updated = False
            return self._pixels

    @property
    def width(self) -> int:
        with self._lock:
            return 0 if self._pixels is None else self._pixels.shape[1]

    @property
    def height(self) -> int:
        with self._lock:
            return 0 if self._pixels is None else self._pixels.shape[0]

    def release(self) -> None:
        with self._lock:
            self._pixels = None
            self._updated = False
