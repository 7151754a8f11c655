"""`pt_dense_kernel<true, false, false, *>` (B1b, the five-lobe form's
flat loop): its least time by `roofline.py` over its device seconds in the
traced window."""
from readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "pt_dense_kernel<true, false, false,",
                           "pt_bsdf_kernel")
