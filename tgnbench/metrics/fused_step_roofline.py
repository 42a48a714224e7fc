"""fused_step_roofline (kernels): the least time one ``fused_step`` call
could take over the round's rows (``counts.fused_step``), over its three
kernels' device time a call in the profiler's window."""
from tgnbench import counts

KERNELS = ("fused_muu_kernel", "fused_eu_kernel", "fused_out_kernel")


def read(r):
    calls = sum(1 for n, _, _ in r.events if KERNELS[0] in n)
    if calls == 0:
        return None
    dev_s = sum(e - s for n, s, e in r.events if any(k in n for k in KERNELS))
    return 100.0 * counts.bound_s(*counts.fused_step(r.cfg, r.rows)) / (
        dev_s / calls)
