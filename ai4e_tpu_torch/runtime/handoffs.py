"""Pipeline handoff builders — stage-to-stage payload shaping; a copy of
``ai4e_tpu/runtime/handoffs.py`` (numpy and PIL only).

The reference's ensembles replay the ORIGINAL request to every stage: its
classifier re-reads the whole camera-trap image. Real detector->classifier
pipelines classify the detector's CROPS, smaller payloads in which the
classifier sees the animal, not the scene. ``crops_handoff`` builds that
stage: it receives the detector's result AND its decoded input image (the
two-argument handoff contract of ``InferenceWorker.serve_model``), crops
each detection box, resizes it to the classifier's input and ships the
stack to the next stage's *batch* endpoint as one npy payload.
"""

from __future__ import annotations

import io

import numpy as np


def crops_handoff(endpoint: str, crop_size: int = 224, max_crops: int = 16,
                  min_score: float | None = None):
    """Handoff callable ``(result, example) -> (endpoint, stack_bytes)``
    or ``None``.

    - ``result``: the detector's postprocess output
      (``{"detections": [{"box": [y0,x0,y1,x1], "score", "class_id"}, ...]}``);
    - ``example``: the decoded input image (H, W, 3), uint8 or float [0,1];
    - crops are clamped to the image, padded to >= 1 px, resized to
      ``(crop_size, crop_size)`` and stacked; ``None`` when nothing (at or
      above ``min_score``) was detected, so the stage completes the task.
    """
    def handoff(result, example):
        detections = (result or {}).get("detections") or []
        if min_score is not None:
            detections = [d for d in detections if d["score"] >= min_score]
        detections = detections[:max_crops]
        if not detections:
            return None

        from .families import cast_image_payload
        img = cast_image_payload(np.asarray(example), np.uint8)
        h, w = img.shape[:2]

        from PIL import Image
        crops = []
        for det in detections:
            y0, x0, y1, x1 = det["box"]
            y0 = int(np.clip(np.floor(y0), 0, h - 1))
            x0 = int(np.clip(np.floor(x0), 0, w - 1))
            y1 = int(np.clip(np.ceil(y1), y0 + 1, h))
            x1 = int(np.clip(np.ceil(x1), x0 + 1, w))
            crop = Image.fromarray(img[y0:y1, x0:x1])
            crop = crop.resize((crop_size, crop_size), Image.BILINEAR)
            crops.append(np.asarray(crop, np.uint8))
        buf = io.BytesIO()
        np.save(buf, np.stack(crops))
        return endpoint, buf.getvalue()

    return handoff
