"""What decides `correct`: the PNGs the window's renders wrote, against the
reference's recomputation of the same pixels.

Which renders and pixels are drawn from the run's seed: every render
whose draw says so (`check.every`), at most `check.renders` of them, and
always the window's last render; in each, `check.pixels` distinct pixels.
The configuration's reference (`reference_for`) recomputes those pixels
from the configuration's files and the render's seed at the render's
size, samples and depth, and quantises them as the PNG writer does.  Two
numbers are compared, each with its limit from the traffic file
(`limits`):

- `max_gap`: the largest difference, in 8-bit levels, of any checked
  channel from the reference's;
- `mismatch_share`: the share of checked channels that differ at all.

A render that failed, a PNG that cannot be read or has another size, or a
window without a finished render is not correct either."""
from __future__ import annotations

import hashlib
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from reference import png, tracer


def draw(seed: int, *key) -> int:
    """A 64-bit number drawn from the run's seed and a key."""
    h = hashlib.blake2b(repr((int(seed),) + key).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def render_seed(seed: int, k: int) -> int:
    """The render seed of the window's k-th render (k = -1: the warm-up)."""
    return draw(seed, "render", k) % (1 << 31)


def kept(seed: int, k: int, every: int) -> bool:
    """Whether render k writes a PNG of its own to be checked."""
    return draw(seed, "keep", k) % every == 0


def pixel_rng(seed: int, k: int) -> np.random.Generator:
    return np.random.default_rng(draw(seed, "pixels", k))


def chosen(renders: List[dict], limit: int) -> List[dict]:
    """The renders to check: the first `limit` kept ones and the last."""
    out = [r for r in renders if r["kept"]][:limit]
    if renders and renders[-1] not in out:
        out.append(renders[-1])
    return out


def reference_for(config: dict, root) -> ModuleType:
    """The configuration's reference module (`config["reference"]`, else
    "analytic"; the contract is `reference/__init__.py`'s), loaded by its
    path under the checkout `root`, so that a checkout's new files are
    the ones read."""
    name = config.get("reference", "analytic")
    if not name.isidentifier():
        raise ValueError(f"reference {name!r} is not a module name")
    path = Path(root) / "benchmark" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare(config: dict, traffic: dict, root, seed: int,
            renders: List[dict], device, stats: Optional[dict] = None
            ) -> Dict[str, float]:
    """The compared numbers over the chosen renders (see the module doc);
    `stats` gains the reference's sample and bounce counts."""
    ref = reference_for(config, root)
    tables = ref.load(config, root)
    w, h = traffic["width"], traffic["height"]
    chk = traffic["check"]
    worst, differ, total, unreadable = 0, 0, 0, 0
    for r in chosen(renders, chk["renders"]):
        rows, cols, ids = tracer.film_pixels(w, h, chk["pixels"],
                                             pixel_rng(seed, r["k"]))
        try:
            img = png.read(r["out"])
        except (OSError, png.PngError):
            unreadable += 1
            continue
        if img.shape[:2] != (h, w):
            unreadable += 1
            continue
        want = ref.render_pixels(tables, config, traffic, ids, r["seed"],
                                 device, torch.float32, stats)
        gap = np.abs(img[rows, cols, :3].astype(np.int64)
                     - want.astype(np.int64))
        worst = max(worst, int(gap.max()))
        differ += int((gap != 0).sum())
        total += gap.size
    return {"max_gap": float(worst if not unreadable else 255),
            "mismatch_share": differ / total if total else 1.0,
            "checked_renders": len(chosen(renders, chk["renders"])),
            "checked_values": total}


def judge(numbers: Dict[str, float], limits: Dict[str, float], failed: int,
          completed: int) -> tuple:
    """(correct, {name: {"value", "limit"}}): every compared number at or
    under its limit, no render failed, and some render finished."""
    shown = {name: {"value": numbers[name], "limit": limit}
             for name, limit in limits.items()}
    ok = all(numbers[name] <= limit for name, limit in limits.items())
    shown["failed_renders"] = {"value": failed, "limit": 0}
    shown["finished_renders"] = {"value": completed, "limit": ">= 1"}
    return ok and failed == 0 and completed > 0, shown
