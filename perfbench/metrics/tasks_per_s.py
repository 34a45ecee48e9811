"""tasks_per_s: tasks retired inside the window (at the wall time of
``on_exit``), over the window."""


def read(rec):
    return len(rec.exits) / rec.seconds
