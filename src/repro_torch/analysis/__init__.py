"""Dry-run analysis: collective wire bytes, the three-term roofline and the
report (the JAX package's ``analysis/``)."""
