"""staging_host_ms (staging): the transfer thread's host time to pack a
batch into a pinned slot and enqueue its copy (``throughput()``'s
``secs_stage_dispatch``), summed over the window's pipelines and divided
by the batches they staged."""


def read(ctx):
    w = ctx.window
    if not w["staged_batches"]:
        return None
    return 1e3 * w["stage_dispatch_s"] / w["staged_batches"]
