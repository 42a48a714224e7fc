"""round_device_ms (step): the device's busy time a round, the union of
every kernel's and copy's interval in the profiler's window, over the
rounds traced."""


def read(r):
    if not r.events:
        return None
    return r.busy_s / r.traced_rounds * 1e3
