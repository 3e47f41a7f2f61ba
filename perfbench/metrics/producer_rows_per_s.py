"""producer_rows_per_s (producers): the cell's producer (same URI, same
threads) drained alone on the host for a fixed number of batches before
the traced window; valid rows over the drain's wall time."""


def read(ctx):
    return ctx.producer_rows_per_s
