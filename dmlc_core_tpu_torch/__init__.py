"""PyTorch/CUDA port of the dmlc_core_tpu training data path.

A second package beside ``dmlc_core_tpu`` (the JAX reference, which it
never imports): rowrec RecordIO → record-aligned split → packed ELL ring
slots → pinned, event-gated host→device staging → sparse learners whose
ELL gather/scatter runs in hand-written CUDA kernels (``ops/csrc``).

Entry points default to ``torch.device("cuda")`` and raise when no card
is present; pass ``device="cpu"`` to run the plain PyTorch versions.
Importing the package loads nothing: the tracker, telemetry and tools
run without torch.
"""

__version__ = "0.1.0"

_ENV_KEYS = (
    "DMLC_TPU_NO_NATIVE",
    "DMLC_TPU_PARSER_THREADS",
    "DMLC_PARSE_THREADS",
    "DMLC_DECODE_CACHE_MB",
    "DMLC_DECODE_THREADS",
    "DMLC_LOG_DEBUG",
    "DMLC_MAX_ATTEMPT",
    "DMLC_RENDEZVOUS_GRACE",
    "DMLC_LINK_WAIT_TIMEOUT",
    "DMLC_YARN_REST",
    "DMLC_TRACE",
    "DMLC_TRACE_DIR",
    "DMLC_TS",
    "DMLC_PROFILE_HIST",
)


def build_info() -> dict:
    """Runtime feature report (the port of the JAX package's
    ``build_info``): the port's parse core and its fused producers, the
    codecs this host decodes, the env flags that are set, and the torch
    runtime (version, CUDA version, each device's name and compute
    capability) with the hash of the CUDA kernels' source and the
    library built from it. Calling it builds the parse core if needed
    and initialises CUDA; importing the package does neither."""
    import os

    from .io.codec import available_codecs

    info = {"version": __version__, "codecs": available_codecs()}
    try:
        from .data import native

        native.load()
        info["native_available"] = True
        info["native_source_hash"] = native.source_hash()
    except Exception as exc:  # no compiler: the plain producers run
        info["native_available"] = False
        info["native_source_hash"] = ""
        info["native_error"] = f"{type(exc).__name__}: {exc}"[:200]
    have = info["native_available"]
    info["fused_kernels"] = {
        k: have
        for k in ("libsvm_dense", "csv_dense", "rowrec_ell", "libfm_ell",
                  "libsvm_ell")
    }
    info["env"] = {k: os.environ[k] for k in _ENV_KEYS if k in os.environ}
    try:
        import torch
    except ImportError:
        info["torch"] = None
        return info
    from .ops import _build

    built = _build.built_library()
    info["kernels"] = {
        "source": "dmlc_core_tpu_torch/ops/csrc/ell_kernels.cu",
        "source_sha256": _build.source_sha256(),
        "library": built.name if built is not None else None,
        "names": sorted(_build.KERNELS),
    }
    info["torch"] = {"version": torch.__version__, "cuda": torch.version.cuda}
    try:
        n = torch.cuda.device_count()
        info["torch"]["device_count"] = n
        info["torch"]["devices"] = [
            {
                "name": torch.cuda.get_device_name(i),
                "capability": "%d.%d" % torch.cuda.get_device_capability(i),
            }
            for i in range(n)
        ]
    except Exception as exc:  # a busy or broken card reads differently
        info["torch"]["device_error"] = f"{type(exc).__name__}: {exc}"[:200]
    return info
