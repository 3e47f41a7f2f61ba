"""staging_adopt_share (staging): the share of the batches the staging
pipelines staged (``staging.batches``, every ``path``) whose packed
buffer the transfer thread copied to the card as it stood, with no pack
copy (``staging.adopted_slots``: ring slots copied in place, adopted
dsserve slots), from the program's registry over the whole process;
nothing where the program keeps no such counter or staged nothing."""

from dmlc_core_tpu_torch.telemetry import default_registry

ADOPTED, BATCHES = "staging.adopted_slots", "staging.batches"


def read(ctx):
    got = default_registry().counter_values(prefix="staging.")
    staged = sum(v for k, v in got.items() if k.split("{")[0] == BATCHES)
    if ADOPTED not in got or not staged:
        return None
    return 100.0 * got[ADOPTED] / staged
