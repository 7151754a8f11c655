"""The benchmark's plain reference: its own `.scn` parser and tables
(`scene`), a plain torch path tracer (`tracer`) and a PNG decoder
(`png`).  It imports torch, numpy and the standard library only, nothing
of the renderer, and takes nothing the renderer made: it reads the scene
file and recomputes any pixel of a render from the render's seed.

A configuration names its reference by the key `"reference"`: the module
`reference/<name>.py`, loaded by its path from the checkout that runs
(`check.reference_for`); without the key, `analytic`.  Each such module
implements one contract:

- `load(config, root) -> tables`: what it needs of the configuration's
  files (its scene, and any `"obj"` or `"env_map"` it names), read under
  the checkout `root` (a `pathlib.Path`);
- `counts(tables) -> dict`: the primitive counts the rooflines read
  (`spheres`, `triangles`, `planes`, `lights`; a mesh reference adds its
  triangles);
- `table_floats(tables) -> int`: the floats of the kernel's scene table,
  for the rooflines' bytes;
- `render_pixels(tables, config, traffic, ids, seed, device, dtype,
  stats) -> np.ndarray`: the 8-bit RGB, uint8 of shape (n, 3), of the
  film pixels `ids` of one render with the render seed `seed` at the
  traffic's width, height, spp and depth, computed in `dtype` on
  `device` and quantised as the PNG writer does; `stats`, a dict or None,
  gains the `samples` and `bounces` it traced.

A reference module imports its siblings by absolute name (`from reference
import scene`), and nothing of the renderer, JAX or Flax."""
