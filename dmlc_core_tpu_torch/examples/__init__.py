"""Ports of the repo's training examples (``examples/``), run as
``python -m dmlc_core_tpu_torch.examples.<name>``; each has a
``main(argv=None, device=None)`` that runs on the card unless
``device`` asks for the CPU."""
