"""The runner's executor (counterpart of ``anovos_tpu/parallel``): node
placement declarations (``placement``) and the dependency-aware DAG
scheduler with its worker pool, watchdog and CUDA streams
(``scheduler``).  The JAX package's mesh and collective helpers serve
multi-device runs, which the port does not have yet (ROADMAP.md Queue A,
multi-device)."""

from anovos_tpu_torch.parallel.placement import Placement, parse_placement
from anovos_tpu_torch.parallel.scheduler import (
    DagScheduler,
    Node,
    NodeTimeout,
    available_cpus,
    default_workers,
)

__all__ = ["DagScheduler", "Node", "NodeTimeout", "Placement", "available_cpus",
           "default_workers", "parse_placement"]
