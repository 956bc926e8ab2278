"""Runnable examples of the port: ``python -m repro_torch.examples.<name>``
(``quickstart``, ``align_reads``, ``serve_lm``), on the card, or on the CPU
with ``--device cpu``."""
