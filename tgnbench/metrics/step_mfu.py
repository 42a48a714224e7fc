"""step_mfu (step): the configuration's operations a round (2 x MACs per
dynamic embedding x the round's 2B x T embeddings, ``counts.stage_macs``)
over the mean round wall of the untraced window and the card's peak for
products at fp32's accuracy (``counts.PEAK_PRODUCTS``, 3xTF32: the
operations are the model's dense layers)."""
import statistics

from tgnbench import counts


def read(r):
    if not r.events or not r.round_wall_s:
        return None
    flops = 2 * counts.stage_macs(r.cfg) * r.rows
    return 100.0 * flops / statistics.fmean(r.round_wall_s) / counts.PEAK_PRODUCTS
