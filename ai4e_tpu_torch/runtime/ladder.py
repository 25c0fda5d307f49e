"""Factory batch-bucket ladders — the constants of ``ai4e_tpu/runtime/
ladder.py``. Traffic-tuned ladder derivation is not ported yet."""

#: ServableModel's default batch buckets.
DEFAULT_BUCKETS = (1, 2, 4, 8)
#: Image-classifier family default (landcover/species/imagenet-class).
IMAGE_BUCKETS = (1, 16, 64)
#: The ``ai4e_batch_size`` exposition ladder.
EXPOSITION_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
