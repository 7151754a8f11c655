"""`pt_mesh_kernel<false>` (B1e, `pt_bsdf_mesh_kernel`, the megamesh
route's kernel): the least time of every render's launches by
`roofline_mesh.py` over the kernel's device seconds in the traced window
(the trace's kernels whose name holds `pt_mesh_kernel<false>`)."""
import roofline
import roofline_mesh


def read(rec):
    tr = rec.get("trace")
    renders = len(rec["renders"])
    launches = rec.get("launches", {}).get("pt_bsdf_mesh_kernel", 0)
    work = rec.get("work") or {}
    counts = rec["tables"]["counts"]
    if (not tr or not renders or not launches or not work.get("samples")
            or "mesh_triangles" not in counts):
        return None
    device_s = sum(s for name, s in tr["ops"].items()
                   if "pt_mesh_kernel<false>" in name)
    if device_s <= 0.0:
        return None
    t = rec["traffic"]
    flops, n_bytes = roofline_mesh.render_work(
        counts, rec["tables"]["floats"], t["width"] * t["height"], t["spp"],
        work["bounces"] / work["samples"], launches / renders)
    return 100.0 * roofline.least_seconds(flops * renders,
                                          n_bytes * renders) / device_s
