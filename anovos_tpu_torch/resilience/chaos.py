"""Deterministic fault injection: the seeded chaos harness (counterpart of
``anovos_tpu/resilience/chaos.py``).

Every recovery path in this package (retry, timeout escalation, backend
failover, graceful degradation) must be EXERCISED in tier-1 tests, not
just believed — the upfront backend probe is explicitly "necessary but
not sufficient" (``shared/backend_probe.py``), and a recovery path that
only runs during a real outage is a recovery path that has never run.

``ANOVOS_TPU_CHAOS`` holds a spec of semicolon-separated directives:

    seed=7;exc@node:stats_generator/*;hang@node:quality_checker/*:secs=600;
    wedge@node:drift_detector/drift_statistics

Each directive is ``kind@site[:opt=val]*``:

* ``exc`` — raise :class:`ChaosError` at the site (a transient node-body
  failure; the scheduler's retry policy must absorb it);
* ``hang`` — block at the site for ``secs`` (default 600) or until the
  scheduler's watchdog interrupts the attempt, which raises
  :class:`ChaosHang` (exercises timeout escalation);
* ``wedge`` — mark the backend as wedged (``backend_wedged()`` reports
  True until a failover clears it) and raise :class:`BackendWedge`
  (exercises mid-run failover: the health probe sees the wedge, flips
  the runtime to CPU, and the node re-executes).

I/O fault kinds fire at the ingest guard's per-part read sites
(``io:<absolute file path>`` — ``data_ingest/guard.py``), the
data-plane analogue of the node faults above:

* ``corrupt`` — raise :class:`ChaosCorrupt` as if the part's contents
  failed to decode (bad magic / mangled pages; the guard must retry,
  then quarantine);
* ``truncate`` — raise :class:`ChaosTruncate` as if the part were cut
  short (the truncated-parquet-footer class; same recovery path, a
  distinct error class in the quarantine manifest);
* ``slowread`` — sleep ``secs`` (default 5) before the read proceeds (a
  degraded NFS/object store; exercises that slow I/O merely slows the
  run instead of tripping any failure path).

Sites are strings like ``node:<scheduler node name>``; the spec side is
an ``fnmatch`` glob, so one directive can target a family of nodes
(first match fires).  ``n=<count>`` bounds how many visits fire (default
1 — exactly one injection, then the site behaves normally, which is what
lets a retried node succeed).  ``p=<float>`` gates each firing on a
SEEDED coin flip (``seed=`` directive, default 0) hash-keyed by
(directive, site, per-site visit number) rather than drawn from a shared
RNG stream, so probabilistic chaos stays reproducible run-to-run even
under the concurrent executor, where sites are visited in
thread-scheduling order.

Everything is inert (one None check per site) unless a plan is
installed.  Installation happens once per run in ``workflow.main`` via
:func:`install_from_env`; fired injections book
``chaos_injections_total{kind,site}`` metrics.

In the port the sites are the ingest guard's ``io:<path>``, the
continuum's ``continuum:fold_committed:<part key>`` (``exc`` there aborts
a step right after a partition's fold committed, the window a resume
must cover), the scheduler's ``node:<name>``, visited before each
attempt of a node (``exc`` and ``hang`` fire there; a hang waits on the
attempt's interrupt, which the watchdog sets), and the feature server's
``serve:apply``, visited in each apply attempt of a micro-batch (the
serve-fault scenario, ``serving/demo.run_serve_fault``).  ``wedge`` fires
at the ``node:`` sites; the backend failover (``resilience/failover.py``)
gives it its outcome: the health probe sees the flag, the runtime flips
to the CPU and the node re-executes there.  Every injection also lands
in the flight recorder's ring (``obs/flight.py``).
"""

from __future__ import annotations

import fnmatch
import hashlib
import logging
import os
import threading
import time
from typing import List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "ChaosError",
    "ChaosHang",
    "ChaosCorrupt",
    "ChaosTruncate",
    "BackendWedge",
    "ChaosPlan",
    "chaos_point",
    "install",
    "install_from_env",
    "plan",
    "reset",
    "backend_wedged",
    "set_wedged",
    "clear_wedge",
]

ENV_KNOB = "ANOVOS_TPU_CHAOS"

_KINDS = ("exc", "hang", "wedge", "corrupt", "truncate", "slowread")


class ChaosError(RuntimeError):
    """An injected node-body failure (the transient-fault simulant)."""


class ChaosHang(ChaosError):
    """An injected hang that the scheduler's watchdog interrupted."""


class BackendWedge(ChaosError):
    """An injected backend wedge: dispatch 'failed' and the simulated
    accelerator stays unresponsive until a failover clears it."""


class ChaosCorrupt(ChaosError):
    """An injected unreadable-part failure (bad magic / mangled pages):
    the ingest guard must retry it, then quarantine the part."""


class ChaosTruncate(ChaosError):
    """An injected truncated-part failure (cut-short footer/rows): same
    recovery path as ``corrupt``, distinct error class in the
    quarantine manifest."""


class _Directive:
    __slots__ = ("kind", "pattern", "n", "secs", "p", "fired", "visits")

    def __init__(self, kind: str, pattern: str, n: int = 1,
                 secs: float = 600.0, p: float = 1.0):
        self.kind = kind
        self.pattern = pattern
        self.n = n
        self.secs = secs
        self.p = p
        self.fired = 0
        self.visits: dict = {}  # site -> matched-visit count (for p= flips)

    def describe(self) -> str:
        return f"{self.kind}@{self.pattern}"


class ChaosPlan:
    """A parsed spec with thread-safe fire accounting."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        self.directives: List[_Directive] = []
        self._lock = threading.Lock()
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                self.seed = int(raw[5:])
                continue
            # grammar: kind@site[:opt=val]* — the site itself may contain
            # ':' (e.g. "node:stats_generator/*"), so ':'-separated tails
            # only count as options when they are a known opt=val pair
            if "@" not in raw:
                raise ValueError(
                    f"chaos directive {raw!r} has no '@site' (spec: kind@site[:opt=val]*)")
            kind, _, rest = raw.partition("@")
            kind = kind.strip()
            if kind not in _KINDS:
                raise ValueError(f"unknown chaos kind {kind!r} (one of {_KINDS})")
            parts = rest.split(":")
            site_parts, opt_parts = [], []
            for part in parts:
                (opt_parts if ("=" in part and opt_parts is not None and
                               part.split("=", 1)[0] in ("n", "secs", "p"))
                 else site_parts).append(part)
            site = ":".join(site_parts)
            d = _Directive(kind, site)
            if kind == "slowread":
                d.secs = 5.0  # a slow read, not a 600s hang (secs= overrides)
            for part in opt_parts:
                k, _, v = part.partition("=")
                if k == "n":
                    d.n = int(v)
                elif k == "secs":
                    d.secs = float(v)
                elif k == "p":
                    d.p = float(v)
            self.directives.append(d)

    def _coin(self, d: _Directive, site: str, visit: int) -> bool:
        """The seeded ``p=`` gate for one (directive, site, visit) — keyed
        by content, not drawn from a shared RNG stream: under the
        concurrent executor, sites are visited in thread-scheduling order,
        so a shared stream would make 'seeded' injections irreproducible.
        Hash-keyed flips give every site's nth visit a fixed verdict
        regardless of interleaving."""
        key = f"{self.seed}:{d.describe()}:{site}:{visit}".encode()
        h = hashlib.sha256(key).digest()
        return (int.from_bytes(h[:8], "big") / float(1 << 64)) < d.p

    def claim(self, site: str) -> List[_Directive]:
        """The directives that fire at this visit of ``site`` (first
        matching directive per kind; firing consumes one of its ``n``)."""
        out: List[_Directive] = []
        with self._lock:
            claimed_kinds = set()
            for d in self.directives:
                if not fnmatch.fnmatchcase(site, d.pattern):
                    continue
                visit = d.visits[site] = d.visits.get(site, 0) + 1
                if d.kind in claimed_kinds or d.fired >= d.n:
                    continue
                if d.p < 1.0 and not self._coin(d, site, visit):
                    continue
                d.fired += 1
                claimed_kinds.add(d.kind)
                out.append(d)
        return out

    def injection_count(self) -> int:
        with self._lock:
            return sum(d.fired for d in self.directives)

    def summary(self) -> dict:
        with self._lock:
            return {
                "spec": self.spec,
                "seed": self.seed,
                "injections": sum(d.fired for d in self.directives),
                "fired": {d.describe(): d.fired
                          for d in self.directives if d.fired},
            }


_PLAN: Optional[ChaosPlan] = None
_WEDGED = threading.Event()


def install(spec: Optional[str]) -> Optional[ChaosPlan]:
    """Install (or clear, with a falsy spec) the process chaos plan."""
    global _PLAN
    clear_wedge()
    if not spec:
        _PLAN = None
        return None
    _PLAN = ChaosPlan(spec)
    logger.warning(
        "CHAOS plan active (%s): %d directive(s), seed=%d — injected faults "
        "are deliberate", ENV_KNOB, len(_PLAN.directives), _PLAN.seed)
    return _PLAN


def install_from_env() -> Optional[ChaosPlan]:
    return install(os.environ.get(ENV_KNOB, ""))


def plan() -> Optional[ChaosPlan]:
    return _PLAN


def reset() -> None:
    install(None)


def backend_wedged() -> bool:
    """True while a simulated backend wedge is in effect (the in-run
    health probe consults this BEFORE paying a real dispatch check)."""
    return _WEDGED.is_set()


def set_wedged() -> None:
    _WEDGED.set()


def clear_wedge() -> None:
    _WEDGED.clear()


def chaos_point(site: str, interrupt: Optional[threading.Event] = None) -> None:
    """One named injection site.  Inert (a single None check) without an
    installed plan.  ``interrupt`` is the scheduler's per-attempt event:
    an injected hang waits on it so the watchdog's escalation can cut the
    hang short (raising :class:`ChaosHang`) instead of leaking a thread.
    """
    p = _PLAN
    if p is None:
        return
    for d in p.claim(site):
        from anovos_tpu_torch.obs import flight, get_metrics, get_tracer

        get_metrics().counter(
            "chaos_injections_total",
            "deliberate chaos-harness fault injections",
        ).inc(kind=d.kind, site=site)
        flight.record("chaos", kind=d.kind, site=site)
        with get_tracer().span(f"chaos:{d.kind}:{site}", cat="chaos", directive=d.describe()):
            logger.warning("chaos: injecting %s at %s", d.kind, site)
            if d.kind == "exc":
                raise ChaosError(f"chaos-injected exception at {site}")
            if d.kind == "corrupt":
                raise ChaosCorrupt(
                    f"chaos-injected corrupt part at {site} (simulated "
                    "bad magic / mangled pages; the ingest guard must "
                    "retry, then quarantine)")
            if d.kind == "truncate":
                raise ChaosTruncate(
                    f"chaos-injected truncated part at {site} (simulated "
                    "cut-short footer; retry, then quarantine)")
            if d.kind == "slowread":
                time.sleep(d.secs)
                continue  # the read proceeds normally, just late
            if d.kind == "wedge":
                set_wedged()
                raise BackendWedge(
                    f"chaos-injected backend wedge at {site} (simulated "
                    "accelerator dispatch failure; health probe reports "
                    "wedged until failover)")
            # hang: wait interruptibly; a watchdog interrupt raises so the
            # scheduler's timeout-retry path re-executes the attempt
            if interrupt is not None:
                if interrupt.wait(d.secs):
                    raise ChaosHang(
                        f"chaos-injected hang at {site} interrupted by the "
                        "watchdog (timeout escalation)")
            else:
                time.sleep(d.secs)
            # slept through the full bound with no interrupt: the "hang"
            # resolved on its own — the node continues normally
