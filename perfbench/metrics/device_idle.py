"""device_idle: the share of the traced span in which no kernel, copy or
memset ran on the device, in %."""


def read(rec):
    t = rec.trace
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
