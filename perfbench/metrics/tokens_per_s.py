"""tokens_per_s: generated tokens the serve emitted inside the window (at
the wall time of ``on_loopback`` or ``on_exit``), over the window."""


def read(rec):
    return len(rec.tokens) / rec.seconds
