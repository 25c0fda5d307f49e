"""Parallel plane (counterpart of ``ai4e_tpu/parallel``): only the
single-device reference attention so far."""
