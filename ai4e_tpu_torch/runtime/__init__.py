"""Serving runtime: servables, the device runtime, the micro-batcher and
the inference worker (counterpart of ``ai4e_tpu/runtime``)."""
