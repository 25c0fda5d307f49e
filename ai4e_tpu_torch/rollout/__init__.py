"""Rollout: the worker's drain (counterpart of ``ai4e_tpu/rollout``; the
canary split and the rollout controller are not ported)."""
