"""Mid-run backend failover (counterpart of
``anovos_tpu/resilience/failover.py``): detect a wedged card, flip the
runtime to the CPU.

A card can fail in the middle of a run: a kernel that faults leaves a
sticky CUDA error, or a dispatch stops answering.  The scheduler then
recovers in the run instead of losing it:

* :func:`backend_healthy`: a bounded in-process dispatch check
  (:func:`probe_in_process`): one tiny op on the runtime's device and an
  ``.item()`` round trip on a named daemon thread, within
  ``ANOVOS_TPU_HEALTH_TIMEOUT`` seconds (default 5).  On the card the op
  runs on a CUDA stream of its own, so a card that is busy but not
  wedged (a worker's stream holding a long kernel) answers within the
  deadline.  The chaos harness's simulated wedge
  (``chaos.backend_wedged()``) short-circuits it to False, so the
  failover path is testable without broken hardware.
* :func:`maybe_failover`: the scheduler's hook on a node failure and on
  an escalated timeout.  It pays the probe only when the wedge flag is
  set, the caller forces it, or the exception looks backend-shaped (the
  texts torch and CUDA raise: ``CUDA error``, ``cudaError``,
  ``CUBLAS_STATUS_``, an illegal memory access, an unspecified launch
  failure, a device-side assert, ``AcceleratorError``, and the chaos
  harness's ``BackendWedge``).  An ordinary error never pays a probe.  On
  an unhealthy verdict it flips once.
* :func:`failover_to_cpu`: the flip, in this order: ``init_runtime("cpu")``
  (which bumps ``runtime_generation()``, so the scheduler takes no worker
  stream for a later attempt and the runner moves the df versions it
  committed on the card to the CPU at their next read), the simulated
  wedge cleared, ``backend_failovers_total``, a ``backend_failover``
  journal record (in the flight recorder's ring, in the journal's shape,
  when the run has no journal), and one warning naming the reason.  The
  hand kernels' wrappers then take their plain versions, as they do on
  any CPU tensor.

One flip a run: the CPU cannot wedge, so a second unhealthy verdict means
the failure is not the backend and the error policy proceeds.  The flip
holds for the rest of the process; ``workflow.main`` re-arms it with
:func:`reset`.  Nothing else here leaves the card: a failure that is not
backend-shaped, or whose probe passes, raises as before.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

logger = logging.getLogger("anovos_tpu_torch.resilience.failover")

__all__ = [
    "backend_healthy",
    "failover_to_cpu",
    "maybe_failover",
    "failover_count",
    "probe_in_process",
    "reset",
]

PROBE_THREAD = "anovos-torch-health-probe"

_LOCK = threading.Lock()
_STATE = {"flipped": False, "count": 0}
_PROBE_STREAMS: dict = {}
_PROBE_LOCK = threading.Lock()

# exception text that earns a (bounded) health probe: what torch and the
# CUDA runtime raise for a failed card, and the chaos harness's wedge
_BACKEND_ERROR_MARKERS = (
    "CUDA error", "cudaError", "CUBLAS_STATUS_", "an illegal memory access",
    "unspecified launch failure", "device-side assert", "AcceleratorError",
    "BackendWedge",
)


def _looks_backend_shaped(exc: BaseException) -> bool:
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _BACKEND_ERROR_MARKERS)


def _dispatch(device) -> bool:
    """One tiny op on ``device`` and its value back on the host; on the
    card on the probe's own stream (taken once a device), so the round
    trip waits for nothing a worker queued."""
    import torch

    if device.type != "cuda":
        return float((torch.ones(1) + 1.0).item()) == 2.0
    with _PROBE_LOCK:
        stream = _PROBE_STREAMS.get(str(device))
        if stream is None:
            stream = _PROBE_STREAMS[str(device)] = torch.cuda.Stream(device=device)
    with torch.cuda.stream(stream):
        return float((torch.ones(1, device=device) + 1.0).item()) == 2.0


def probe_in_process(timeout_s: float) -> bool:
    """Bounded in-process dispatch check of the runtime's device (the CPU
    when none is set): :func:`_dispatch` must return True within
    ``timeout_s`` on a daemon thread named ``anovos-torch-health-probe``.
    A wedged dispatch leaves that thread behind; the caller flips to the
    CPU after the first failed probe, so at most one is ever left."""
    import torch

    from anovos_tpu_torch.shared.runtime import peek_runtime

    rt = peek_runtime()
    device = rt.device if rt is not None else torch.device("cpu")
    done = threading.Event()
    result = {"ok": False}

    def _run():
        try:
            result["ok"] = bool(_dispatch(device))
        except Exception:
            result["ok"] = False
        finally:
            done.set()

    threading.Thread(target=_run, name=PROBE_THREAD, daemon=True).start()
    if not done.wait(timeout_s):
        return False  # the probe thread is wedged with the card
    return result["ok"]


def backend_healthy(timeout_s: Optional[float] = None) -> bool:
    """Bounded answer to "is the runtime's device dispatching?".  A
    chaos-simulated wedge reports unhealthy at once; otherwise one tiny op
    must round-trip within ``ANOVOS_TPU_HEALTH_TIMEOUT`` seconds (default
    5)."""
    from anovos_tpu_torch.resilience import chaos

    if chaos.backend_wedged():
        return False
    if timeout_s is None:
        timeout_s = float(os.environ.get("ANOVOS_TPU_HEALTH_TIMEOUT", "5"))
    return probe_in_process(timeout_s)


def failover_to_cpu(reason: str, journal=None) -> bool:
    """Flip the runtime to the CPU; False when this run has flipped
    already (or the CPU runtime could not be set)."""
    with _LOCK:
        if _STATE["flipped"]:
            return False
        _STATE["flipped"] = True
        _STATE["count"] += 1
    from anovos_tpu_torch.obs import flight, get_metrics
    from anovos_tpu_torch.resilience import chaos
    from anovos_tpu_torch.shared.runtime import init_runtime

    try:
        init_runtime("cpu")
    except Exception:
        logger.exception("backend failover: CPU runtime failed; the run continues on the card")
        return False
    chaos.clear_wedge()
    get_metrics().counter("backend_failovers_total", "mid-run backend failovers (accelerator -> cpu)").inc()
    if journal is not None:
        try:
            journal.append("backend_failover", reason=str(reason)[:300])
        except Exception:
            logger.exception("backend_failover journal append failed")
    else:
        # without a journal the flip still reaches the flight recorder's
        # ring, in the shape a journal append records it
        flight.record("journal", event="backend_failover", reason=str(reason)[:300])
    logger.warning("backend failover: the card is unresponsive (%s); runtime flipped to the CPU mid-run — "
                   "committed node results are kept, the in-flight frontier re-executes", reason)
    return True


def maybe_failover(exc: Optional[BaseException] = None, journal=None, force_probe: bool = False) -> bool:
    """The scheduler's failure hook: probe if suspicious, flip if wedged.

    True when this call flipped the runtime (the caller then grants the
    failed node one re-execution outside its retry budget).  Ordinary
    errors return False without paying a probe."""
    from anovos_tpu_torch.resilience import chaos

    suspicious = force_probe or chaos.backend_wedged() or (exc is not None and _looks_backend_shaped(exc))
    if not suspicious:
        return False
    with _LOCK:
        if _STATE["flipped"]:
            return False
    if backend_healthy():
        return False
    return failover_to_cpu(reason=repr(exc) if exc is not None else "health probe timeout", journal=journal)


def failover_count() -> int:
    with _LOCK:
        return _STATE["count"]


def reset() -> None:
    """Per-run reset (``workflow.main``): a new run may probe and flip
    again."""
    with _LOCK:
        _STATE["flipped"] = False
        _STATE["count"] = 0
