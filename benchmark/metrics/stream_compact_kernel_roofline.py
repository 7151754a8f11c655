"""The streaming compactor (B3a `stream_pack_kernel` and B3b
`stream_unpack_kernel`): the least bytes of every render's packs and
unpacks by `roofline_hybrid.py` over the memory rate, over the two
kernels' device seconds in the traced window.  None without either
kernel in the trace or the reference's counts."""
import roofline
import roofline_hybrid

KERNELS = ("stream_pack_kernel", "stream_unpack_kernel")


def read(rec):
    tr = rec.get("trace")
    renders = len(rec["renders"])
    work = rec.get("work") or {}
    if (not tr or not renders or not work.get("samples")
            or "box_rays" not in work):
        return None
    device_s = sum(s for name, s in tr["ops"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0.0:
        return None
    t = rec["traffic"]
    n_bytes = roofline_hybrid.compact_bytes(
        t["width"] * t["height"], t["spp"],
        work["box_rays"] / work["samples"],
        work.get("stage_rays", 0) / work["samples"])
    return 100.0 * roofline.least_seconds(0.0, n_bytes * renders) / device_s
