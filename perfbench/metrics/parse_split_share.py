"""parse_split_share (producers): the share of the rows the fused
producers emitted (``staging.rows_out``) that native calls split over
more than one thread parsed (``staging.parse_split_rows``), from the
program's registry over the whole process; nothing where the program
keeps no such counter."""

from dmlc_core_tpu_torch.telemetry import default_registry

SPLIT, OUT = "staging.parse_split_rows", "staging.rows_out"


def read(ctx):
    got = default_registry().counter_values(names=(SPLIT, OUT))
    if SPLIT not in got or not got.get(OUT):
        return None
    return 100.0 * got[SPLIT] / got[OUT]
