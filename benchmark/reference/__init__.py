"""The benchmark's plain reference: its own `.scn` parser and tables
(`scene`), a plain torch path tracer (`tracer`) and a PNG decoder
(`png`).  It imports torch, numpy and the standard library only, nothing
of the renderer, and takes nothing the renderer made: it reads the scene
file and recomputes any pixel of a render from the render's seed."""
