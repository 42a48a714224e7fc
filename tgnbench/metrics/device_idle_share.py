"""device_idle_share (device): 1 - round_device_ms / the mean round wall of
the same run's untraced window (the profiler's own cost inflates a traced
round's wall several-fold, so the wall is taken before it starts)."""
import statistics


def read(r):
    if not r.events or not r.round_wall_s:
        return None
    busy = r.busy_s / r.traced_rounds
    return 100.0 * (1.0 - busy / statistics.fmean(r.round_wall_s))
