"""setup_s: seconds from the process's start to the window's: imports,
kernel builds or loads, weights, the engine, the warm-up serve."""


def read(rec):
    return rec.setup_s
