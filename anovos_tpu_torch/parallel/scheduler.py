"""Dependency-aware DAG executor for the workflow runner (counterpart of
``anovos_tpu/parallel/scheduler.py``).

Each config block registers as a node declaring the resources it
``reads`` and ``writes`` (the current ``df`` version, stats CSVs, report
subtrees), and nodes whose inputs are ready run concurrently on a
bounded worker pool.  Device work on the card and host work (pandas,
pyarrow, CSV and HTML writing) both release the GIL for most of their
time, so one block's device compute overlaps another's host work.

* **Edges are derived, not declared.**  ``add()`` wires read-after-write,
  write-after-write and write-after-read dependencies from the declared
  resource sets, always pointing at ALREADY-registered nodes, so the graph
  is acyclic by construction and registration order is a valid topological
  order.  Sequential mode executes that order on the caller's thread,
  which is the YAML walk.
* **Failure semantics.**  A node registered ``on_error="raise"`` aborts
  the run: no new nodes start, in-flight nodes finish, and the ORIGINAL
  exception is re-raised.  ``"continue"`` nodes log and count as done.
  ``"retry:N[:degrade|:continue]"`` re-executes a failed node up to N
  times with the policy's deterministic backoff (``resilience.policy``);
  an exhausted ``retry:N:degrade`` node records itself in the degradation
  registry (the report's Degraded Sections tab reads it) and the run goes
  on.  Before each attempt the executor visits the chaos site
  ``node:<name>`` (``resilience.chaos``: ``exc`` and ``hang`` fire there).
* **Hang watchdog with escalation** (concurrent mode).  ``node_timeout``
  bounds any single attempt.  A node's FIRST expiry interrupts the
  attempt (the per-attempt ``interrupt`` event a chaos hang waits on) and
  re-allows it under the bound times ``policy.timeout_factor``; a retry
  node re-executes once after such an interrupt.  When the escalated
  bound also expires, a ``retry:N:degrade`` node is abandoned (its
  interrupt is set again, so a cooperative hang unwinds; a thread stuck
  elsewhere leaks as a daemon; a replacement worker keeps the pool's
  width) and degraded; any other node ends the run with
  :class:`NodeTimeout` naming the block.
* **CUDA streams.**  In concurrent mode on the card every node whose
  placement is not ``host`` runs under ``torch.cuda.stream`` of its
  worker, and its stream is synchronized before the attempt ends.  Worker
  slot i of every run takes the process's i-th stream, so the caching
  allocator's per-stream pools are reused from run to run instead of
  growing with each run's new streams.  So a dependent on another
  stream never reads an unfinished df version, and a tensor that a node
  drops cannot be handed by the caching allocator to another stream while
  this node's kernels still read it.  Host nodes take no stream.
  Sequential mode runs every node on the caller's current stream.
* **Run record.**  Each node runs inside its tracer span (``deps``,
  ``queue_wait_s``, ``lane``, ``scheduler``) and its devprof bracket
  (``obs/devprof.py``), and books ``node_wall_seconds`` and
  ``node_queue_wait_seconds``.  The devprof drain is the stream sync at
  the end of each attempt: in the concurrent mode the worker stream's
  sync above, booked as device time under ``ANOVOS_TPU_DEVPROF=full``
  only (a node's sync waits on its own stream, but the card is shared, so
  the default books none, as the JAX executor drains no concurrent
  node); in the sequential mode on the card a sync of the caller's
  current stream at the end of each attempt, always booked (unless
  ``ANOVOS_TPU_DEVPROF=0``, which also drops the sync).  Either sync is
  inside the attempt, so a CUDA error it surfaces meets the node's error
  policy.
* **Summary.**  ``run()`` returns per-node start/end/thread spans, the
  measured critical path (longest dependency chain by wall time), the
  serial seconds and the parallel speedup.

The JAX executor's node cache (ROADMAP.md Queue A item 1; the summary's
``cache`` section says ``enabled: false``), flight dumps and telemetry
gauges (item 3), backend failover (item 4) and multi-device lanes
(item 5) are not ported: nothing here stands in for them.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Union

from anovos_tpu_torch.obs import devprof, get_metrics, get_tracer
from anovos_tpu_torch.parallel.placement import Placement, parse_placement
from anovos_tpu_torch.resilience.policy import ErrorPolicy, parse_policy

logger = logging.getLogger(__name__)

__all__ = ["DagScheduler", "Node", "NodeTimeout", "available_cpus", "default_workers"]


class NodeTimeout(RuntimeError):
    """A node exceeded the scheduler's per-node timeout (names the block)."""


def default_workers() -> int:
    """Worker-pool width: ``ANOVOS_TPU_EXECUTOR_WORKERS``, else the host's
    usable CPUs clamped to [2, 8] (two workers still overlap device
    compute with host file I/O on a one-core host)."""
    env = os.environ.get("ANOVOS_TPU_EXECUTOR_WORKERS", "")
    if env:
        return max(1, int(env))
    return max(2, min(8, available_cpus()))


def available_cpus() -> int:
    """CPUs this process may actually run on — cgroup/cpuset-aware where the
    platform supports it (os.cpu_count() reports the host's cores even in a
    container pinned to one)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # pragma: no cover - non-Linux
        return os.cpu_count() or 1


class Node:
    __slots__ = (
        "name", "fn", "reads", "writes", "on_error", "deps", "dependents",
        "pending", "state", "start", "end", "ready", "thread", "error",
        "placement", "on_stream",
        "policy", "attempts", "attempt_start", "interrupt",
        "timeout_retried", "escalated", "degraded", "abandoned",
    )

    def __init__(self, name: str, fn: Callable[[], None], reads, writes,
                 on_error: Union[str, ErrorPolicy],
                 placement: Union[None, str, Placement] = None):
        self.name = name
        self.fn = fn
        self.reads = tuple(reads)
        self.writes = tuple(writes)
        self.placement = parse_placement(placement)  # raises on unknown kind
        self.on_stream = False      # ran under a worker's CUDA stream
        self.policy = parse_policy(on_error)   # raises on an unknown mode
        self.on_error = self.policy.describe()
        self.deps: List["Node"] = []
        self.dependents: List["Node"] = []
        self.pending = 0            # unfinished deps (concurrent mode)
        self.state = "pending"      # pending|running|done|failed|failed-continued|degraded|skipped
        self.start = self.end = 0.0
        self.ready = 0.0            # when the last dep finished (queue-wait origin)
        self.thread = ""
        self.error: Optional[BaseException] = None
        self.attempts = 0           # executions of the body this run
        self.attempt_start = 0.0    # monotonic start of the CURRENT attempt
        self.interrupt = threading.Event()  # per-attempt cooperative interrupt
        self.timeout_retried = False   # the one escalated-bound re-execution
        self.escalated = False      # watchdog raised this node's bound once
        self.degraded = False       # retries exhausted; section marked degraded
        self.abandoned = False      # watchdog gave up on a stuck attempt

    @property
    def queue_wait(self) -> float:
        """Seconds spent ready-but-unstarted (worker-pool contention)."""
        if self.start and self.ready:
            return max(self.start - self.ready, 0.0)
        return 0.0


_STREAMS: Dict[tuple, object] = {}
_STREAMS_LOCK = threading.Lock()


def _worker_stream(device, slot: int):
    """The process's CUDA stream for worker slot ``slot`` on ``device``."""
    import torch

    with _STREAMS_LOCK:
        key = (str(device), slot)
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(device=device)
        return _STREAMS[key]


@contextlib.contextmanager
def _on_stream(torch, stream, book: bool):
    """Run the block on ``stream`` and wait for everything it queued there
    before leaving it, failed or not (a retry must not overlap a failed
    attempt's kernels).  That sync is the node's devprof drain, booked as
    device time when ``book``."""
    with torch.cuda.stream(stream):
        try:
            yield
        finally:
            devprof.drain_stream(stream, book=book)


@contextlib.contextmanager
def _drained(torch, device):
    """Sequential mode on the card: sync the caller's current stream at the
    end of the attempt, failed or not, and book it as the node's device
    time."""
    try:
        yield
    finally:
        devprof.drain_stream(torch.cuda.current_stream(device))


class DagScheduler:
    """Register nodes with resource reads/writes, then ``run()`` them."""

    def __init__(self, name: str = "dag"):
        self.name = name
        self._nodes: List[Node] = []
        self._by_name: Dict[str, Node] = {}
        self._last_writer: Dict[str, Node] = {}
        self._readers_since_write: Dict[str, List[Node]] = {}
        self._res_lock = threading.Lock()
        self._res_stats = {"retries": 0, "timeout_retries": 0, "timeout_escalations": 0}
        self._device = None          # the card, when nodes run on streams
        self._drain_device = None    # the card, when sequential nodes drain
        self._devprof_drain = True   # book drains as device time
        self._worker = threading.local()  # each worker thread's slot

    # -- registration ----------------------------------------------------
    def add(
        self,
        name: str,
        fn: Callable[[], None],
        reads: Iterable[str] = (),
        writes: Iterable[str] = (),
        on_error: Union[str, ErrorPolicy] = "raise",
        placement: Union[None, str, Placement] = None,
    ) -> Node:
        """Register ``fn`` as node ``name``.

        A read of a resource nobody has written yet is an external input
        (immediately available), as in the sequential runner, where a
        consumer registered before its producer would also find only what
        pre-exists on disk.  ``on_error`` is ``"raise"``, ``"continue"``,
        ``"retry:N[:degrade|:continue]"`` or an ``ErrorPolicy``;
        ``placement`` (``None`` means ``host``) is kept on the node.
        """
        if name in self._by_name:
            raise ValueError(f"duplicate node name {name!r}")
        node = Node(name, fn, reads, writes, on_error, placement=placement)
        deps: "dict[int, Node]" = {}  # id -> Node, insertion-ordered, deduped
        for r in node.reads:
            w = self._last_writer.get(r)
            if w is not None:
                deps[id(w)] = w  # read-after-write
        for w in node.writes:
            prev = self._last_writer.get(w)
            if prev is not None:
                deps[id(prev)] = prev  # write-after-write
            for rd in self._readers_since_write.get(w, ()):
                deps[id(rd)] = rd  # write-after-read
        deps.pop(id(node), None)
        node.deps = list(deps.values())
        for d in node.deps:
            d.dependents.append(node)
        # update resource maps AFTER wiring so a node never depends on itself
        for r in node.reads:
            self._readers_since_write.setdefault(r, []).append(node)
        for w in node.writes:
            self._last_writer[w] = node
            self._readers_since_write[w] = []
        self._nodes.append(node)
        self._by_name[name] = node
        return node

    def __len__(self) -> int:
        return len(self._nodes)

    # -- execution -------------------------------------------------------
    def run(
        self,
        mode: Optional[str] = None,
        max_workers: Optional[int] = None,
        node_timeout: Optional[float] = None,
    ) -> dict:
        """Execute all nodes; returns the run summary (see ``_summary``).

        ``mode`` defaults to ``ANOVOS_TPU_EXECUTOR`` (``concurrent`` unless
        set to ``sequential``).  ``node_timeout`` defaults to
        ``ANOVOS_TPU_NODE_TIMEOUT`` seconds (0 disables the watchdog).
        """
        mode = mode or os.environ.get("ANOVOS_TPU_EXECUTOR", "concurrent")
        if mode not in ("concurrent", "sequential"):
            raise ValueError(f"unknown executor mode {mode!r} (concurrent|sequential)")
        if node_timeout is None:
            node_timeout = float(os.environ.get("ANOVOS_TPU_NODE_TIMEOUT", "900"))
        t0 = time.monotonic()
        # a drain is a stream sync, which waits out everything queued on
        # that stream: fine when nodes run one at a time; in the concurrent
        # mode ANOVOS_TPU_DEVPROF=full opts in to booking it
        self._devprof_drain = (mode == "sequential"
                               or os.environ.get("ANOVOS_TPU_DEVPROF", "") == "full")
        from anovos_tpu_torch.shared.runtime import peek_runtime

        rt = peek_runtime()  # never pick a device just to run a graph
        card = rt.device if rt is not None and rt.device.type == "cuda" else None
        if mode == "sequential":
            workers = 1
            self._device = None
            self._drain_device = card if devprof.enabled() else None
            self._run_sequential()
        else:
            workers = min(max_workers or default_workers(), max(len(self._nodes), 1))
            self._device = card
            self._drain_device = None
            if self._device is not None:
                import torch

                # what the caller queued (the ingested table) lands before
                # a worker's stream reads it
                torch.cuda.synchronize(self._device)
            self._run_concurrent(workers, node_timeout)
        return self._summary(time.monotonic() - t0, mode, workers)

    def _node_scope(self, node: Node):
        """The worker's CUDA stream for a device node in a concurrent run
        on the card; the drain of the current stream for any node in a
        sequential run on the card; nothing otherwise."""
        if self._drain_device is not None:
            import torch

            return _drained(torch, self._drain_device)
        if self._device is None or not node.placement.on_device:
            return contextlib.nullcontext()
        import torch

        node.on_stream = True
        return _on_stream(torch, _worker_stream(self._device, self._worker.slot),
                          book=self._devprof_drain)

    def _drains(self, node: Node) -> bool:
        """Whether this node's devprof frame books a drain: in the
        sequential mode always, in the concurrent mode under
        ANOVOS_TPU_DEVPROF=full for the nodes that run on a worker stream
        (a host node takes none, so nothing drains it)."""
        if self._device is None:
            return self._devprof_drain
        return self._devprof_drain and node.placement.on_device

    def _execute(self, node: Node) -> None:
        node.state = "running"
        node.thread = threading.current_thread().name
        node.start = time.monotonic()
        lane = node.placement.describe()
        try:
            with get_tracer().span(node.name, cat="node", deps=[d.name for d in node.deps],
                                   queue_wait_s=round(node.queue_wait, 4), lane=lane,
                                   scheduler=self.name), \
                    devprof.node_bracket(node.name, drain=self._drains(node), lane=lane):
                self._run_attempts(node)
            if not node.abandoned:
                node.state = "degraded" if node.degraded else "done"
        except BaseException as e:
            node.error = e
            if node.policy.mode == "continue" or (
                node.policy.mode == "retry"
                and node.policy.on_exhausted == "continue"
            ):
                node.state = "failed-continued"
                logger.exception("node %r failed; continuing (on_error=%s)",
                                 node.name, node.on_error)
            else:
                node.state = "failed"
                raise
        finally:
            node.end = time.monotonic()
            reg = get_metrics()
            reg.histogram("node_wall_seconds", "scheduler node execution wall time"
                          ).observe(node.end - node.start, node=node.name)
            reg.histogram("node_queue_wait_seconds", "ready-to-start wait behind the worker pool"
                          ).observe(node.queue_wait, node=node.name)

    # -- resilience --------------------------------------------------------
    def _run_attempts(self, node: Node) -> None:
        """Execute the node body under its error policy: chaos injection
        site, the one escalated-timeout re-execution, bounded retries with
        backoff, and terminal degradation, in that precedence order."""
        from anovos_tpu_torch.resilience import chaos
        from anovos_tpu_torch.resilience import policy as rpolicy

        pol = node.policy
        # re-execution of either kind is only sound for retry-mode nodes: a
        # node registered "raise"/"continue" opted out (e.g. the stability
        # node, whose cross-run metric-file appends could double-book)
        retryable = pol.mode == "retry"
        retries_left = pol.retries if retryable else 0
        while True:
            node.attempts += 1
            node.attempt_start = time.monotonic()
            if node.interrupt.is_set():
                node.interrupt = threading.Event()  # fresh event per attempt
            try:
                with self._node_scope(node):
                    chaos.chaos_point(f"node:{node.name}", interrupt=node.interrupt)
                    node.fn()
                return
            except KeyboardInterrupt:
                raise
            except BaseException as e:
                if node.abandoned:
                    return  # the watchdog booked this node degraded: no retry
                # 1) watchdog-interrupted attempt: one re-execution at the
                #    escalated bound before the error policy applies at all
                if retryable and node.interrupt.is_set() and not node.timeout_retried:
                    node.timeout_retried = True
                    self._note_retry(node, e, kind="timeout_retry")
                    continue
                # 2) policy retries with exponential backoff + jitter
                if retries_left > 0:
                    retries_left -= 1
                    self._note_retry(node, e, kind="retry")
                    time.sleep(rpolicy.backoff_delay(node.name, node.attempts, pol))
                    continue
                # 3) exhausted: degrade (the run continues, the section is
                #    marked) or propagate to _execute's raise/continue
                if pol.mode == "retry" and pol.on_exhausted == "degrade":
                    node.degraded = True
                    node.error = e
                    rpolicy.record_degraded(node.name, f"{type(e).__name__}: {e}")
                    logger.warning(
                        "node %r exhausted %d attempt(s) (%r); marking its "
                        "section DEGRADED and continuing — the report renders "
                        "a placeholder", node.name, node.attempts, e)
                    return
                raise

    def _note_retry(self, node: Node, exc: BaseException, kind: str) -> None:
        get_metrics().counter("node_retries_total", "scheduler node re-executions after failure",
                              ).inc(node=node.name, kind=kind)
        with self._res_lock:
            self._res_stats["retries"] += 1
            if kind == "timeout_retry":
                self._res_stats["timeout_retries"] += 1
        logger.warning("node %r attempt %d failed (%r); re-executing (%s)",
                       node.name, node.attempts, exc, kind)

    def _run_sequential(self) -> None:
        for node in self._nodes:
            node.ready = time.monotonic()  # no pool: ready == start
            self._execute(node)

    def _run_concurrent(self, max_workers: int, node_timeout: float) -> None:
        cv = threading.Condition()
        ready: List[Node] = []
        running: Dict[str, Node] = {}
        state = {"stop": False, "fatal": None, "done": 0, "spawned": 0}
        total = len(self._nodes)
        t_ready0 = time.monotonic()
        for n in self._nodes:
            n.pending = len(n.deps)
            if n.pending == 0:
                n.ready = t_ready0
                ready.append(n)

        def unblock(node: Node) -> None:
            """Caller holds ``cv``."""
            for dep in node.dependents:
                dep.pending -= 1
                if dep.pending == 0 and not state["stop"]:
                    dep.ready = time.monotonic()
                    ready.append(dep)

        def finish(node: Node) -> None:
            with cv:
                if node.abandoned:
                    # the watchdog already booked this node (degraded) and
                    # unblocked its dependents; this is the zombie attempt
                    # finally waking, and its result is discarded
                    cv.notify_all()
                    return
                running.pop(node.name, None)
                state["done"] += 1
                if node.state == "failed" and state["fatal"] is None:
                    state["fatal"] = node.error
                    state["stop"] = True
                elif node.state in ("done", "failed-continued", "degraded"):
                    unblock(node)
                cv.notify_all()

        def worker(slot: int) -> None:
            self._worker.slot = slot
            while True:
                with cv:
                    node = None
                    while not state["stop"] and state["done"] < total:
                        if ready:
                            node = ready.pop(0)
                            break
                        cv.wait(0.05)
                    if node is None:
                        return
                    node.state = "claimed"
                    # attempt_start is the watchdog's clock origin; set it
                    # BEFORE dispatch so a node is never observed at 0.0
                    node.attempt_start = time.monotonic()
                    running[node.name] = node
                try:
                    self._execute(node)
                except BaseException:
                    pass  # recorded on the node; surfaced via state["fatal"]
                finish(node)
                if node.abandoned:
                    # this thread is the zombie the watchdog replaced: a
                    # substitute worker already holds its pool slot
                    return

        def spawn_worker() -> None:
            slot = state["spawned"]  # a replacement takes a new slot: the zombie keeps its stream
            state["spawned"] += 1
            threading.Thread(
                target=worker, args=(slot,), name=f"{self.name}-w{slot}", daemon=True,
            ).start()

        def abandon(node: Node, reason: str) -> None:
            """Watchdog verdict on a truly stuck retry+degrade node: book it
            degraded WITHOUT its (zombie) thread, unblock dependents, and
            replace the lost worker.  Caller holds ``cv``."""
            from anovos_tpu_torch.resilience import policy as rpolicy

            node.abandoned = True
            node.interrupt.set()  # a cooperative hang in the zombie unwinds
            node.degraded = True
            node.error = NodeTimeout(reason)
            node.state = "degraded"
            node.end = time.monotonic()
            rpolicy.record_degraded(node.name, reason)
            logger.warning("%s — abandoning the stuck attempt (thread leaked, "
                           "worker replaced) and DEGRADING the section", reason)
            running.pop(node.name, None)
            state["done"] += 1
            unblock(node)
            spawn_worker()

        for _ in range(min(max_workers, max(total, 1))):
            spawn_worker()
        with cv:
            while state["done"] < total:
                if state["stop"] and not running:
                    break
                cv.wait(0.1)
                if not (node_timeout and node_timeout > 0):
                    continue
                now = time.monotonic()
                expired: Optional[Node] = None
                for node in list(running.values()):
                    factor = node.policy.timeout_factor if node.escalated else 1.0
                    if now - node.attempt_start <= node_timeout * factor:
                        continue
                    if not node.escalated:
                        # first expiry: escalate, don't abort — interrupt the
                        # attempt (a chaos hang observes the event and
                        # unwinds into the timeout-retry path) and grant the
                        # raised bound
                        node.escalated = True
                        node.attempt_start = now
                        node.interrupt.set()
                        with self._res_lock:
                            self._res_stats["timeout_escalations"] += 1
                        get_metrics().counter("node_timeout_escalations_total",
                                              "watchdog timeouts escalated instead of fatal",
                                              ).inc(node=node.name)
                        logger.warning(
                            "node %r exceeded its %.1fs bound; interrupting the "
                            "attempt and escalating once to %.1fs before the "
                            "error policy applies", node.name, node_timeout,
                            node_timeout * node.policy.timeout_factor)
                        continue
                    expired = node
                    break
                if expired is None:
                    continue
                reason = (
                    f"scheduler node {expired.name!r} still running after its escalated "
                    f"bound ({node_timeout:.0f}s x{expired.policy.timeout_factor:g}) "
                    f"— likely hung; (raise ANOVOS_TPU_NODE_TIMEOUT if the block "
                    f"is legitimately slow)"
                )
                if expired.policy.mode == "retry" and expired.policy.on_exhausted == "degrade":
                    abandon(expired, reason)
                    cv.notify_all()
                    continue
                state["stop"] = True
                state["fatal"] = NodeTimeout(reason)
                cv.notify_all()
                break
        for n in self._nodes:
            if n.state in ("pending", "claimed"):
                n.state = "skipped"
        if state["fatal"] is not None:
            raise state["fatal"]
        # workers exit on their own once done == total (daemon threads)

    # -- observability ---------------------------------------------------
    def _summary(self, wall_s: float, mode: str, workers: int) -> dict:
        executed = [n for n in self._nodes if n.end > 0.0]
        origin = min((n.start for n in executed), default=0.0)
        durs = {n.name: n.end - n.start for n in executed}
        serial = sum(durs.values())
        # longest dependency chain by measured duration; registration order
        # is a topological order so one forward pass suffices
        best: Dict[str, float] = {}
        prev: Dict[str, Optional[str]] = {}
        for n in self._nodes:
            d = durs.get(n.name, 0.0)
            pick, plen = None, 0.0
            for dep in n.deps:
                if best.get(dep.name, 0.0) > plen:
                    pick, plen = dep.name, best[dep.name]
            best[n.name] = d + plen
            prev[n.name] = pick
        chain: List[str] = []
        if best:
            cur: Optional[str] = max(best, key=lambda k: best[k])
            cp_len = best[cur]
            while cur is not None:
                chain.append(cur)
                cur = prev[cur]
            chain.reverse()
        else:
            cp_len = 0.0
        with self._res_lock:
            res_stats = dict(self._res_stats)
        # the most nodes in flight at once, from the measured spans (> 1
        # shows the executor really overlapped nodes)
        events = sorted(ev for n in executed for ev in ((n.start, 1), (n.end, -1)))
        in_flight = overlap = 0
        for _, delta in events:
            in_flight += delta
            overlap = max(overlap, in_flight)
        from anovos_tpu_torch.shared.runtime import peek_runtime

        rt = peek_runtime()
        return {
            "mode": mode,
            "workers": workers,  # the pool width this run actually used
            "n_devices": rt.n_devices if rt is not None else 1,
            "multidev_overlap": overlap,
            "wall_s": round(wall_s, 4),
            "serial_s": round(serial, 4),
            "critical_path_s": round(cp_len, 4),
            "parallel_speedup": round(serial / wall_s, 3) if wall_s > 0 else 0.0,
            "critical_path": chain,
            # the node cache is not ported: every node executes
            "cache": {"enabled": False, "hits": 0, "misses": 0, "restore_s": 0.0,
                      "uncacheable": len(self._nodes)},
            "resilience": {
                **res_stats,
                "degraded": sorted(n.name for n in self._nodes if n.degraded),
            },
            "nodes": {
                n.name: {
                    "start_s": round(n.start - origin, 4) if n.end else None,
                    "end_s": round(n.end - origin, 4) if n.end else None,
                    "dur_s": round(n.end - n.start, 4) if n.end else None,
                    "queue_wait_s": round(n.queue_wait, 4) if n.end else None,
                    "thread": n.thread,
                    "lane": n.placement.describe(),
                    "devices": [],
                    "stream": n.on_stream,
                    "state": n.state,
                    "cached": False,
                    "attempts": n.attempts,
                    "escalated": n.escalated,
                    "degraded": n.degraded,
                    "deps": [d.name for d in n.deps],
                }
                for n in self._nodes
            },
        }

    @staticmethod
    def format_summary(summary: dict) -> str:
        """One-paragraph critical-path report for the run log."""
        chain = summary.get("critical_path", [])
        nodes = summary.get("nodes", {})
        hops = " -> ".join(
            f"{name} ({nodes.get(name, {}).get('dur_s') or 0.0:.2f}s)" for name in chain
        )
        return (
            f"scheduler[{summary.get('mode')}]: wall={summary.get('wall_s'):.2f}s "
            f"serial={summary.get('serial_s'):.2f}s "
            f"critical_path={summary.get('critical_path_s'):.2f}s "
            f"parallel_speedup={summary.get('parallel_speedup'):.2f}x "
            f"longest chain: {hops}"
        )
