"""rows_per_batch: live rows per stage batch over the window's batches
(``num_real_rows / num_batches`` of the engine's counts, taken at
``on_batch``)."""


def read(rec):
    if not rec.batches:
        return None
    return sum(b[3] for b in rec.batches) / len(rec.batches)
