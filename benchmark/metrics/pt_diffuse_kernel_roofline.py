"""`pt_dense_kernel<false, false, false, *>` (B1a, the diffuse form's
flat loop): its least time by `roofline.py` over its device seconds in the
traced window."""
from readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "pt_dense_kernel<false, false, false,",
                           "pt_diffuse_kernel")
