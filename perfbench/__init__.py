"""The benchmark of ``dmlc_core_tpu_torch``: one command runs one cell
(a configuration under a traffic mix) and prints one JSON line. See
``README.md`` beside this file."""
