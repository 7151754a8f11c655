"""Mean device milliseconds a render in the traced window's kernels other
than the hybrid route's hand-written ones (B2 `mesh_sweep_kernel`, B3a
`stream_pack_kernel`, B3b `stream_unpack_kernel`), copies and memsets:
the wavefront's eager bounce math, the sort and the camera rays.  The
few kernels of scene prep, outside the render phase, are counted with
them.  None without a trace or without such kernels."""
HAND = ("mesh_sweep_kernel", "stream_pack_kernel", "stream_unpack_kernel")


def read(rec):
    tr = rec.get("trace")
    renders = len(rec["renders"])
    if not tr or not renders:
        return None
    device_s = sum(s for name, s in tr["ops"].items()
                   if not name.startswith(("Memcpy", "Memset"))
                   and not any(k in name for k in HAND))
    return 1e3 * device_s / renders if device_s > 0.0 else None
