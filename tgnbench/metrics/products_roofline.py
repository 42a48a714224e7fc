"""products_roofline (kernels): the least time of the teacher's products a
round (``counts.products_bound_s``: each product's operations and bytes
from its shapes), over the device time a round of the GEMM kernels that run
them (cuBLAS's names) in the profiler's window."""
import re

from tgnbench import counts

GEMM = re.compile(r"gemm|gemv|sgemm|xmma|cutlass|splitKreduce|dot_kernel",
                  re.IGNORECASE)


def read(r):
    dev_s = sum(e - s for n, s, e in r.events if GEMM.search(n))
    if dev_s == 0:
        return None
    bound = counts.products_bound_s(r.cfg, r.rows // r.tenants, r.tenants)
    return 100.0 * bound * r.traced_rounds / dev_s
