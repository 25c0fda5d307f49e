"""Rollout: the worker's drain and the generation label of its rollout
series (counterpart of ``ai4e_tpu/rollout``; ``CanaryWeights`` and the
rollout controller are not ported, ROADMAP A18.9 and A19)."""
