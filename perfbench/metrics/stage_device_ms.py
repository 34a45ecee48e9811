"""stage_device_ms: the device's busy time in the traced span (the union of
its kernels' intervals, from the profiler) over the stage batches
dispatched in it, in ms."""


def read(rec):
    t = rec.trace
    if t is None or not t["batches"]:
        return None
    return t["busy_s"] / t["batches"] * 1e3
