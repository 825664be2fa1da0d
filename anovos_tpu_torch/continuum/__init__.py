"""anovos_tpu_torch.continuum — continuous incremental feature engineering
(counterpart of ``anovos_tpu/continuum``).

The batch pipeline as a long-running service: a partition-arrival loop
over mergeable sufficient statistics.  Every per-partition statistic is a
monoid (``sufficient.py``: ``from_chunk`` / ``merge`` / ``finalize``),
the state persists behind a write-ahead journal with content-addressed
snapshots in the cache store (``state.py``), the watcher folds newly
landed part files through the prefetch pool and re-finalizes the
artifacts in O(new rows) (``watcher.py``), and threshold crossings emit
structured alerts with the flight recorder's tail (``alerts.py``).
``python -m anovos_tpu_torch.continuum`` is the CLI (``run`` / ``step``
/ ``status``); a ``continuous_analysis`` workflow block runs one step.
"""

from anovos_tpu_torch.continuum.state import ContinuumState  # noqa: F401
from anovos_tpu_torch.continuum.sufficient import (  # noqa: F401
    ACCUMULATORS,
    Accumulator,
    DriftSpec,
    FoldContext,
    PartFrame,
    register_accumulator,
)
from anovos_tpu_torch.continuum.watcher import (  # noqa: F401
    ContinuumConfig,
    run,
    status,
    step,
)

__all__ = [
    "ACCUMULATORS",
    "Accumulator",
    "ContinuumConfig",
    "ContinuumState",
    "DriftSpec",
    "FoldContext",
    "PartFrame",
    "register_accumulator",
    "run",
    "status",
    "step",
]
