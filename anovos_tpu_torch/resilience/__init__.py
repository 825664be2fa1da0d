"""Fault injection, error policy and failover of the port (counterpart of
``anovos_tpu/resilience``): the seeded chaos harness (``chaos``), the
retry/backoff policy with the degradation registry (``policy``), the
mid-run backend failover to the CPU (``failover``), and the workflow
chaos scenarios (``scenarios``, ``python -m
anovos_tpu_torch.resilience.scenarios``).
"""

from anovos_tpu_torch.resilience import chaos, failover, policy
from anovos_tpu_torch.resilience.chaos import (
    BackendWedge,
    ChaosCorrupt,
    ChaosError,
    ChaosHang,
    ChaosPlan,
    ChaosTruncate,
    chaos_point,
)
from anovos_tpu_torch.resilience.failover import (
    backend_healthy,
    failover_to_cpu,
    maybe_failover,
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
    "failover",
    "policy",
    "BackendWedge",
    "ChaosCorrupt",
    "ChaosError",
    "ChaosHang",
    "ChaosPlan",
    "ChaosTruncate",
    "chaos_point",
    "backend_healthy",
    "failover_to_cpu",
    "maybe_failover",
    "ErrorPolicy",
    "backoff_delay",
    "degraded_sections",
    "parse_policy",
    "record_degraded",
    "reset_degraded",
]
