"""`mesh_sweep_kernel` (B2, the hybrid route's blocked sweep): the least
time of every render's sweeps by `roofline_hybrid.py` over the kernel's
device seconds in the traced window.  None without the kernel in the
trace or the reference's counts."""
import roofline
import roofline_hybrid


def read(rec):
    tr = rec.get("trace")
    renders = len(rec["renders"])
    work = rec.get("work") or {}
    counts = rec["tables"]["counts"]
    if (not tr or not renders or not work.get("samples")
            or "box_rays" not in work or "mesh_triangles" not in counts):
        return None
    device_s = sum(s for name, s in tr["ops"].items()
                   if "mesh_sweep_kernel" in name)
    if device_s <= 0.0:
        return None
    t = rec["traffic"]
    flops, n_bytes = roofline_hybrid.sweep_work(
        counts, t["width"] * t["height"], t["spp"],
        work["box_rays"] / work["samples"])
    return 100.0 * roofline.least_seconds(flops * renders,
                                          n_bytes * renders) / device_s
