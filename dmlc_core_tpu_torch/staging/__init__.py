"""Fixed-shape batching and double-buffered host→device staging (the port
of ``dmlc_core_tpu/staging``): ragged RowBlocks → static-shape batches
(``batcher``), the native producers (``fused``) and the pinned,
event-gated pipeline (``pipeline``).

The names below load their module on first use: ``batcher`` and
``fused`` run without torch (a dsserve server imports them), and
``pipeline`` imports torch.
"""

import importlib

_EXPORTS = {
    "Batch": "batcher",
    "BatchSpec": "batcher",
    "FixedShapeBatcher": "batcher",
    "alloc_packed_slot": "batcher",
    "gather_slices": "batcher",
    "packed_shard_layout": "batcher",
    "FusedDenseCSVBatches": "fused",
    "FusedDenseLibSVMBatches": "fused",
    "FusedEllLibFMBatches": "fused",
    "FusedEllLibSVMBatches": "fused",
    "FusedEllRowRecBatches": "fused",
    "ShardedFusedBatches": "fused",
    "dense_batches": "fused",
    "ell_batches": "fused",
    "StagingPipeline": "pipeline",
    "StagingStats": "pipeline",
    "device_put": "pipeline",
    "drain_close": "pipeline",
    "stage_batch": "pipeline",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
