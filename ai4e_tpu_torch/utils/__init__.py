"""Shared helpers — the part of ``ai4e_tpu/utils`` the port uses."""
