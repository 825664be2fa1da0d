"""Fault injection and error policy of the port (counterpart of
``anovos_tpu/resilience``): the seeded chaos harness (``chaos``) and the
retry/backoff policy with the degradation registry (``policy``).  The
JAX package's mid-run failover is not ported (ROADMAP.md Queue A item 4).
"""

from anovos_tpu_torch.resilience import chaos, policy
from anovos_tpu_torch.resilience.chaos import (
    BackendWedge,
    ChaosCorrupt,
    ChaosError,
    ChaosHang,
    ChaosPlan,
    ChaosTruncate,
    chaos_point,
)
from anovos_tpu_torch.resilience.policy import (
    ErrorPolicy,
    backoff_delay,
    degraded_sections,
    parse_policy,
    record_degraded,
    reset_degraded,
)

__all__ = [
    "chaos",
    "policy",
    "BackendWedge",
    "ChaosCorrupt",
    "ChaosError",
    "ChaosHang",
    "ChaosPlan",
    "ChaosTruncate",
    "chaos_point",
    "ErrorPolicy",
    "backoff_delay",
    "degraded_sections",
    "parse_policy",
    "record_degraded",
    "reset_degraded",
]
