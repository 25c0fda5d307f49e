"""Admission control: end-to-end deadlines, priority shedding and adaptive
concurrency; counterpart of ``ai4e_tpu/admission``.

Opt-in with ``PlatformConfig(admission=True)`` /
``AI4E_PLATFORM_ADMISSION=1``. Three parts:

- ``deadline``: the ``X-Deadline-Ms`` / ``X-Priority`` /
  ``X-Shed-Reason`` vocabulary every hop shares, and the ``expired``
  terminal status;
- ``controller``: the latency-gradient AIMD limiter that resizes the
  gateway's sync in-flight cap and each dispatcher's delivery loops, the
  drain-rate Retry-After and the goodput metrics;
- ``shedder``: the lowest priority refused first, with a computed
  backoff.

Under orchestration the controller consults the degradation ladder
first (brownout refusals at both edges); under resilience a breaker that
opens backs the dispatcher's limiter off at once.
"""

from .controller import (AdmissionController, AdmissionScope, DecayingRate,
                         GradientLimiter)
from .deadline import (BACKGROUND, DEADLINE_AT_HEADER, DEADLINE_MS_HEADER,
                       DEFAULT, INTERACTIVE, PRIORITY_CLASSES,
                       PRIORITY_HEADER, SHED_REASON_HEADER, DeadlineExceeded,
                       drain_retry_after, expired, expired_status,
                       parse_deadline_at, parse_priority, priority_name,
                       propagation_headers, remaining_s, shed_reason,
                       worker_admission_kwargs)
from .shedder import PriorityShedder

__all__ = [
    "AdmissionController", "AdmissionScope", "DecayingRate",
    "GradientLimiter", "PriorityShedder", "DeadlineExceeded",
    "DEADLINE_AT_HEADER", "DEADLINE_MS_HEADER", "PRIORITY_HEADER",
    "SHED_REASON_HEADER", "PRIORITY_CLASSES", "INTERACTIVE", "DEFAULT",
    "BACKGROUND", "drain_retry_after", "expired", "expired_status",
    "parse_deadline_at", "parse_priority", "priority_name",
    "propagation_headers", "remaining_s", "shed_reason",
    "worker_admission_kwargs",
]
