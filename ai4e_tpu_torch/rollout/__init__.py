"""Rollout: the worker's drain, the generation label of its rollout
series and the canary split (counterpart of ``ai4e_tpu/rollout``; the
rollout controller is not ported, ROADMAP A19)."""
