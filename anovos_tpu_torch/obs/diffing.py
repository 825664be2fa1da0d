"""The perf doctor: structural run-diffing with ranked regression
attribution (counterpart of ``anovos_tpu/obs/diffing.py`` and, as
``python -m anovos_tpu_torch.obs.diffing``, of ``tools/perf_doctor.py``).

It takes two runs (two ``obs/run_manifest.json`` documents, or two
perf-ledger entries) and gives one machine-readable **diagnosis**: a
ranked list naming which node phase, cache input, env knob or executor
change moved.  Its readers:

* the CLI below (``--baseline``/``--candidate`` run dirs or manifest
  files, ledger-entry mode, ``--self-check``);
* ``obs.flight.build_snapshot``: the live ``/statusz`` document and every
  postmortem dump carry :func:`live_node_summary` under ``doctor`` (this
  run's nodes against the last completed run in the same obs dir);
* the report's Run Diff tab (``data_report.report_generation``).

The port's manifests have no ``compile_census`` (eager torch compiles
nothing), so their ``programs`` section is null; a JAX manifest's census
is still diffed.  ``cuda`` is an ``accel`` backend class, as ``tpu`` is.

Diagnosis JSON schema (version 1)
---------------------------------

The schema below is the contract ``validate_diagnosis`` enforces and the
``--self-check`` gate pins::

    {
      "diagnosis_version": 1,
      "kind": "manifest" | "ledger",
      "backend_class": "cpu" | "accel" | "unknown",
      "baseline":  {"label", "config_hash"?, "backend"?, "wall_s"?,
                    "generated_unix"?},
      "candidate": {same shape},
      "wall_delta_s": float | null,          # scheduler wall movement
      "executor_change": [base, cand] | null,
      # manifest kind -------------------------------------------------
      "nodes": {name: {                      # union of both node sets
          "status": "common" | "added" | "removed",
          "wall_s": [base|null, cand|null], "wall_delta_s": float|null,
          "phases": {device_time_s,dispatch_s,transfer_s,host_s: delta}|null,
          "dominant_phase": str|null,        # largest |phase delta|
          "queue_wait_delta_s": float|null,  # reported, NEVER scored —
                                             # queue wait is executor
                                             # scheduling, not node cost
          "cached": [bool|null, bool|null],
          "degraded": [bool, bool]}} | null,
      "programs": {                          # compile-census set diff
          "baseline_distinct": int, "candidate_distinct": int,
          "new": [names], "retired": [names],
          "count_changed": {name: [base_count, cand_count]},
          "compile_wall_delta_s": float,
          "nodes_touched": [node names]} | null,
      "cache": {"re_executed": [names],      # cached in base, ran in cand
                "newly_cached": [names],
                "moved_inputs": [str]} | null,   # which fingerprint input
                                                 # moved: config slice /
                                                 # env knob / code /
                                                 # dataset signature
      "env": {"changed_knobs": {knob: [base|null, cand|null]},
              "code_version": [base, cand] | null,
              "dataset_changed": bool | null} | null,
      # ledger kind ---------------------------------------------------
      "fields": {name: {"baseline": num|null, "candidate": num|null,
                        "delta": num|null, "pct": float|null,
                        "flagged": bool}} | null,
      # both kinds ----------------------------------------------------
      "attributions": [{                     # ranked, rank 1..N
          "rank": int, "kind": str, "subject": str,
          "severity": "structural" | "timing" | "info",
          "score": float,                    # ranking key within severity
          "delta_s": float | null,
          "detail": str}],
    }

Attribution ``kind`` values: ``degraded`` / ``node_added`` /
``node_removed`` (structural), ``programs`` / ``phase`` / ``cache`` /
``node`` / ``field`` (timing), ``env`` / ``executor`` (info).  Ranking is
``(severity, -score, kind, subject)`` with structural first — a newly
degraded section outranks any timing movement, and env-knob changes are
listed but never outrank measured seconds.

Determinism contract: the diagnosis is a pure function of its two inputs
— no timestamps, no environment reads — and :func:`canonical` dumps it
with sorted keys and fixed separators, so diffing the same pair twice is
byte-identical (the ``--self-check`` gate).

Cross-backend-class pairs are REFUSED loudly (:class:`DiffRefused`): a
cpu-fallback run diffed against an accelerator run is a different
machine, not a regression — same policy as the perf-ledger gate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "DIAGNOSIS_VERSION",
    "DiffRefused",
    "backend_class",
    "canonical",
    "diff_manifests",
    "diff_ledger_entries",
    "find_manifest",
    "live_node_summary",
    "main",
    "render_text",
    "validate_diagnosis",
]

DIAGNOSIS_VERSION = 1

# phase keys of one devprof node entry, in attribution order
PHASE_KEYS = ("device_time_s", "dispatch_s", "transfer_s", "host_s")

# seconds below which a phase/node movement is measurement noise, not a
# diagnosis line (the nodes map still records the raw delta)
_MIN_S = 0.001

_SEVERITY_RANK = {"structural": 0, "timing": 1, "info": 2}


class DiffRefused(ValueError):
    """Raised when two runs are not comparable (cross-backend-class)."""


def backend_class(backend) -> str:
    """'cpu' | 'accel' | 'unknown', the perf-ledger gate's partition."""
    b = str(backend or "").lower()
    if not b or b == "none":
        return "unknown"
    if b.startswith("cpu"):
        return "cpu"
    return "accel"


def canonical(diagnosis: dict) -> str:
    """Deterministic serialization (sorted keys, fixed separators) — the
    byte-identity the self-check gate compares."""
    return json.dumps(diagnosis, sort_keys=True, separators=(",", ":"))


def _r(x, nd: int = 6):
    return None if x is None else round(float(x), nd)


def _refuse_cross_class(base_cls: str, cand_cls: str) -> str:
    if base_cls != "unknown" and cand_cls != "unknown" and base_cls != cand_cls:
        raise DiffRefused(
            f"refusing to diff across backend classes: baseline is "
            f"{base_cls!r}, candidate is {cand_cls!r} — a different machine "
            "is not a regression (run the doctor on same-class pairs)")
    return cand_cls if cand_cls != "unknown" else base_cls


def _truncate(names: Iterable[str], n: int = 3) -> str:
    names = list(names)
    head = ", ".join(names[:n])
    return head + (f", +{len(names) - n} more" if len(names) > n else "")


def _rank(attributions: List[dict]) -> List[dict]:
    """Sort by (severity, -score, kind, subject) and stamp 1-based ranks."""
    out = sorted(
        attributions,
        key=lambda a: (_SEVERITY_RANK.get(a["severity"], 3), -a["score"],
                       a["kind"], a["subject"]))
    for i, a in enumerate(out):
        a["rank"] = i + 1
    return out


# -- manifest diff --------------------------------------------------------

def _man_meta(man: dict, label: str) -> dict:
    sched = man.get("scheduler") or {}
    return {
        "label": label,
        "config_hash": man.get("config_hash"),
        "backend": man.get("backend"),
        "wall_s": _r(sched.get("wall_s"), 4),
        "generated_unix": man.get("generated_unix"),
    }


def _node_wall(name: str, devprof: dict, sched_nodes: dict) -> Optional[float]:
    d = devprof.get(name)
    if isinstance(d, dict) and isinstance(d.get("wall_s"), (int, float)):
        return float(d["wall_s"])
    nd = sched_nodes.get(name) or {}
    return float(nd["dur_s"]) if isinstance(nd.get("dur_s"), (int, float)) else None


def _degraded_nodes(man: dict) -> Dict[str, str]:
    """{node: reason} — scheduler flags unioned with the resilience
    section's degraded_sections reasons."""
    out: Dict[str, str] = {}
    res = man.get("resilience") or {}
    sections = res.get("degraded_sections") or {}
    if isinstance(sections, dict):
        out.update({str(k): str(v) for k, v in sections.items()})
    sched = (man.get("scheduler") or {})
    for name in (sched.get("resilience") or {}).get("degraded", []) or []:
        out.setdefault(str(name), "degraded (retries exhausted)")
    for name, nd in (sched.get("nodes") or {}).items():
        if isinstance(nd, dict) and nd.get("degraded"):
            out.setdefault(str(name), "degraded (retries exhausted)")
    return out


def diff_manifests(baseline: dict, candidate: dict,
                   baseline_label: str = "baseline",
                   candidate_label: str = "candidate") -> dict:
    """Structural diff of two ``run_manifest.json`` documents.

    Raises :class:`DiffRefused` on cross-backend-class pairs.  Output
    follows the module-docstring schema (``kind="manifest"``)."""
    cls = _refuse_cross_class(backend_class(baseline.get("backend")),
                              backend_class(candidate.get("backend")))
    b_sched = baseline.get("scheduler") or {}
    c_sched = candidate.get("scheduler") or {}
    b_nodes = b_sched.get("nodes") or {}
    c_nodes = c_sched.get("nodes") or {}
    b_dev = baseline.get("devprof") or {}
    c_dev = candidate.get("devprof") or {}
    attributions: List[dict] = []

    # --- per-node diff + phase decomposition ---------------------------
    nodes_out: Dict[str, dict] = {}
    phase_totals = {k: 0.0 for k in PHASE_KEYS}
    phase_movers: Dict[str, List[Tuple[float, str]]] = {k: [] for k in PHASE_KEYS}  # (signed delta, node)
    for name in sorted(set(b_nodes) | set(c_nodes) | set(b_dev) | set(c_dev)):
        in_b = name in b_nodes or name in b_dev
        in_c = name in c_nodes or name in c_dev
        bw = _node_wall(name, b_dev, b_nodes) if in_b else None
        cw = _node_wall(name, c_dev, c_nodes) if in_c else None
        status = "common" if (in_b and in_c) else ("added" if in_c else "removed")
        phases = None
        dominant = None
        if status == "common":
            bd, cd = b_dev.get(name), c_dev.get(name)
            if isinstance(bd, dict) and isinstance(cd, dict):
                phases = {}
                for k in PHASE_KEYS:
                    d = float(cd.get(k) or 0.0) - float(bd.get(k) or 0.0)
                    phases[k] = _r(d)
                    phase_totals[k] += d
                    if abs(d) >= _MIN_S:
                        phase_movers[k].append((d, name))
                if any(abs(v) > 0 for v in phases.values()):
                    dominant = max(PHASE_KEYS, key=lambda k: (abs(phases[k]), k))
        bq = (b_nodes.get(name) or {}).get("queue_wait_s")
        cq = (c_nodes.get(name) or {}).get("queue_wait_s")
        nodes_out[name] = {
            "status": status,
            "wall_s": [_r(bw), _r(cw)],
            "wall_delta_s": _r(cw - bw) if (bw is not None and cw is not None) else None,
            "phases": phases,
            "dominant_phase": dominant,
            # queue wait is EXECUTOR scheduling (a concurrent run waits
            # where a sequential one cannot) — recorded for the reader,
            # never booked as a regression attribution
            "queue_wait_delta_s": (_r(cq - bq)
                                   if isinstance(bq, (int, float))
                                   and isinstance(cq, (int, float)) else None),
            "cached": [(b_nodes.get(name) or {}).get("cached"),
                       (c_nodes.get(name) or {}).get("cached")],
            "degraded": [bool((b_nodes.get(name) or {}).get("degraded")),
                         bool((c_nodes.get(name) or {}).get("degraded"))],
        }
        if status != "common":
            wall = cw if status == "added" else bw
            attributions.append({
                "kind": f"node_{status}", "subject": name,
                "severity": "structural", "score": _r(abs(wall or 0.0)) or 0.0,
                "delta_s": _r(cw) if status == "added" else _r(-(bw or 0.0)),
                "detail": (f"node {name!r} only in the "
                           f"{'candidate' if status == 'added' else 'baseline'} "
                           f"run (wall {wall if wall is not None else '?'}s) — "
                           "the registration set changed"),
            })

    # --- newly degraded sections (structural, outrank everything) ------
    b_deg, c_deg = _degraded_nodes(baseline), _degraded_nodes(candidate)
    for name in sorted(set(c_deg) - set(b_deg)):
        base_wall = _node_wall(name, b_dev, b_nodes)
        attributions.append({
            "kind": "degraded", "subject": name, "severity": "structural",
            "score": _r(base_wall or 0.0) or 0.0, "delta_s": None,
            "detail": (f"node {name!r} DEGRADED in the candidate run "
                       f"({c_deg[name]}) but clean in the baseline — its "
                       "statistics are missing, not slower"),
        })

    # --- phase aggregate attributions ----------------------------------
    for k in PHASE_KEYS:
        total = phase_totals[k]
        if abs(total) < _MIN_S:
            continue
        movers = sorted(phase_movers[k], key=lambda t: (-abs(t[0]), t[1]))[:3]
        mover_txt = ", ".join(f"{n} ({d:+.3f}s)" for d, n in movers) \
            or "no single node dominates"
        attributions.append({
            "kind": "phase", "subject": k, "severity": "timing",
            "score": _r(abs(total)) or 0.0, "delta_s": _r(total),
            "detail": (f"{k} moved {total:+.3f}s across the common node set; "
                       f"top movers: {mover_txt}"),
        })

    # --- compile-census program-set diff -------------------------------
    programs = None
    b_cen, c_cen = baseline.get("compile_census"), candidate.get("compile_census")
    if isinstance(b_cen, dict) and isinstance(c_cen, dict):
        b_prog = {p.get("program"): p for p in (b_cen.get("programs") or [])
                  if isinstance(p, dict)}
        c_prog = {p.get("program"): p for p in (c_cen.get("programs") or [])
                  if isinstance(p, dict)}
        new = sorted(set(c_prog) - set(b_prog))
        retired = sorted(set(b_prog) - set(c_prog))
        count_changed = {
            n: [int(b_prog[n].get("count") or 0), int(c_prog[n].get("count") or 0)]
            for n in sorted(set(b_prog) & set(c_prog))
            if int(b_prog[n].get("count") or 0) != int(c_prog[n].get("count") or 0)
        }
        wall_delta = (float(c_cen.get("compile_seconds_total") or 0.0)
                      - float(b_cen.get("compile_seconds_total") or 0.0))
        touched = sorted({nd for n in new + retired
                          for nd in (c_prog.get(n) or b_prog.get(n) or {}).get("nodes", [])})
        programs = {
            "baseline_distinct": int(b_cen.get("distinct_programs") or 0),
            "candidate_distinct": int(c_cen.get("distinct_programs") or 0),
            "new": new, "retired": retired, "count_changed": count_changed,
            "compile_wall_delta_s": _r(wall_delta),
            "nodes_touched": touched,
        }
        n_changes = len(new) + len(retired) + len(count_changed)
        if n_changes:
            attributions.append({
                "kind": "programs", "subject": "program_set",
                "severity": "timing",
                # compile wall is the measurable cost; a warm/warm pair
                # with equal walls still surfaces on the count fallback
                "score": _r(max(abs(wall_delta), 0.01 * n_changes)) or 0.0,
                "delta_s": _r(wall_delta),
                "detail": (f"program set moved: +{len(new)} new, "
                           f"-{len(retired)} retired, {len(count_changed)} "
                           f"shape-count changed (distinct "
                           f"{programs['baseline_distinct']} -> "
                           f"{programs['candidate_distinct']}, compile wall "
                           f"{wall_delta:+.3f}s)"
                           + (f"; new: {_truncate(new)}" if new else "")
                           + (f"; retired: {_truncate(retired)}" if retired else "")
                           + (f"; nodes touched: {_truncate(touched)}"
                              if touched else "")),
            })

    # --- env / fingerprint-input diff ----------------------------------
    env = None
    b_env, c_env = baseline.get("env"), candidate.get("env")
    if isinstance(b_env, dict) or isinstance(c_env, dict):
        b_env, c_env = b_env or {}, c_env or {}
        bk, ck = b_env.get("knobs") or {}, c_env.get("knobs") or {}
        changed = {k: [bk.get(k), ck.get(k)]
                   for k in sorted(set(bk) | set(ck)) if bk.get(k) != ck.get(k)}
        code = None
        if (b_env.get("code_version") and c_env.get("code_version")
                and b_env["code_version"] != c_env["code_version"]):
            code = [b_env["code_version"], c_env["code_version"]]
        ds = None
        if b_env.get("dataset_fingerprint") and c_env.get("dataset_fingerprint"):
            ds = b_env["dataset_fingerprint"] != c_env["dataset_fingerprint"]
        env = {"changed_knobs": changed, "code_version": code,
               "dataset_changed": ds}
        for knob, (bv, cv) in changed.items():
            b_txt = "unset" if bv is None else repr(bv)
            c_txt = "unset" if cv is None else repr(cv)
            attributions.append({
                "kind": "env", "subject": knob, "severity": "info",
                "score": 0.0, "delta_s": None,
                "detail": f"env knob {knob} moved: {b_txt} -> {c_txt}",
            })

    # --- cache hit-set diff --------------------------------------------
    cache = None
    b_cache, c_cache = baseline.get("cache"), candidate.get("cache")
    any_cached = any(bool((nd or {}).get("cached"))
                     for nd in list(b_nodes.values()) + list(c_nodes.values()))
    if b_cache or c_cache or any_cached:
        re_exec = sorted(
            n for n in set(b_nodes) & set(c_nodes)
            if (b_nodes[n] or {}).get("cached") and not (c_nodes[n] or {}).get("cached"))
        newly = sorted(
            n for n in set(b_nodes) & set(c_nodes)
            if not (b_nodes[n] or {}).get("cached") and (c_nodes[n] or {}).get("cached"))
        moved: List[str] = []
        if baseline.get("config_hash") != candidate.get("config_hash"):
            moved.append("config slice (config_hash moved)")
        if env:
            moved.extend(f"env knob {k}" for k in (env["changed_knobs"] or {}))
            if env.get("code_version"):
                moved.append("code ({} -> {})".format(*env["code_version"]))
            if env.get("dataset_changed"):
                moved.append("dataset signature")
        if re_exec and not moved:
            moved.append("upstream node output or cache-store state")
        cache = {"re_executed": re_exec, "newly_cached": newly,
                 "moved_inputs": moved}
        if re_exec:
            cost = sum(_node_wall(n, c_dev, c_nodes) or 0.0 for n in re_exec)
            attributions.append({
                "kind": "cache", "subject": "re_executed",
                "severity": "timing", "score": _r(cost) or 0.0,
                "delta_s": _r(cost),
                "detail": (f"{len(re_exec)} node cone(s) re-executed that the "
                           f"baseline restored from cache ({_truncate(re_exec)}; "
                           f"{cost:.3f}s of candidate wall); moved fingerprint "
                           f"input(s): {', '.join(moved)}"),
            })

    # --- executor-mode change (informational) --------------------------
    b_mode = (baseline.get("executor") or {}).get("mode") or b_sched.get("mode")
    c_mode = (candidate.get("executor") or {}).get("mode") or c_sched.get("mode")
    executor_change = None
    if b_mode != c_mode:
        executor_change = [b_mode, c_mode]
        attributions.append({
            "kind": "executor", "subject": "mode", "severity": "info",
            "score": 0.0, "delta_s": None,
            "detail": (f"executor mode moved {b_mode!r} -> {c_mode!r}: "
                       "queue-wait movement is scheduling, not node cost, "
                       "and is deliberately not booked as a regression"),
        })

    bw, cw = _man_meta(baseline, baseline_label), _man_meta(candidate, candidate_label)
    wall_delta = (None if bw["wall_s"] is None or cw["wall_s"] is None
                  else _r(cw["wall_s"] - bw["wall_s"], 4))
    return {
        "diagnosis_version": DIAGNOSIS_VERSION,
        "kind": "manifest",
        "backend_class": cls,
        "baseline": bw,
        "candidate": cw,
        "wall_delta_s": wall_delta,
        "executor_change": executor_change,
        "nodes": nodes_out or None,
        "programs": programs,
        "cache": cache,
        "env": env,
        "fields": None,
        "attributions": _rank(attributions),
    }


# -- perf-ledger entry diff ----------------------------------------------

def diff_ledger_entries(baseline: dict, candidate: dict,
                        flagged: Iterable[str] = ()) -> dict:
    """Diff two perf-ledger entries (the schema ``obs/ledger.py`` reads).

    ``flagged`` names the fields the gate judged regressions — they rank
    structurally first so the diagnosis leads with the complaint.  When
    both entries carry a ``nodes`` summary (the bench's per-node split),
    per-node wall movement is attributed with its dominant phase."""
    b_cls = baseline.get("backend_class") or backend_class(baseline.get("backend"))
    c_cls = candidate.get("backend_class") or backend_class(candidate.get("backend"))
    cls = _refuse_cross_class(b_cls, c_cls)
    flagged = set(flagged)
    b_fields = baseline.get("fields") or {}
    c_fields = candidate.get("fields") or {}
    fields_out: Dict[str, dict] = {}
    attributions: List[dict] = []
    for name in sorted(set(b_fields) | set(c_fields)):
        bv, cv = b_fields.get(name), c_fields.get(name)
        ok = all(isinstance(v, (int, float)) and not isinstance(v, bool)
                 for v in (bv, cv))
        delta = _r(cv - bv) if ok else None
        pct = (_r((cv - bv) / bv * 100.0, 2)
               if ok and bv not in (0, 0.0) else None)
        fields_out[name] = {
            "baseline": _r(bv) if isinstance(bv, (int, float)) else None,
            "candidate": _r(cv) if isinstance(cv, (int, float)) else None,
            "delta": delta, "pct": pct, "flagged": name in flagged,
        }
        if pct is not None and (delta or 0.0) != 0.0:
            attributions.append({
                "kind": "field", "subject": name,
                "severity": "structural" if name in flagged else "timing",
                "score": _r(abs(pct) / 100.0) or 0.0, "delta_s": None,
                "detail": (f"field {name} moved {bv:g} -> {cv:g} "
                           f"({pct:+.1f}%)"
                           + (" — FLAGGED by the ledger gate"
                              if name in flagged else "")),
            })

    b_nodes = baseline.get("nodes") or {}
    c_nodes = candidate.get("nodes") or {}
    nodes_out = None
    if b_nodes and c_nodes:
        nodes_out = {}
        for name in sorted(set(b_nodes) | set(c_nodes)):
            bn, cn = b_nodes.get(name) or {}, c_nodes.get(name) or {}
            bw, cw = bn.get("wall_s"), cn.get("wall_s")
            ok = all(isinstance(v, (int, float)) for v in (bw, cw))
            phases = {k: _r(float(cn.get(k) or 0.0) - float(bn.get(k) or 0.0))
                      for k in PHASE_KEYS if k in bn or k in cn}
            dominant = (max(phases, key=lambda k: (abs(phases[k]), k))
                        if phases and any(abs(v or 0) > 0 for v in phases.values())
                        else None)
            nodes_out[name] = {
                "status": "common" if (bn and cn) else ("added" if cn else "removed"),
                "wall_s": [_r(bw), _r(cw)],
                "wall_delta_s": _r(cw - bw) if ok else None,
                "phases": phases or None,
                "dominant_phase": dominant,
                "queue_wait_delta_s": None,
                "cached": [None, None],
                "degraded": [False, False],
            }
            if ok and bw > 0:
                rel = (cw - bw) / bw
                if abs(rel) >= 0.05 and abs(cw - bw) >= _MIN_S:
                    dom_txt = ""
                    if dominant:
                        dom_txt = (f"; dominant phase: {dominant} "
                                   f"({phases[dominant]:+.3f}s)")
                    attributions.append({
                        "kind": "node", "subject": name, "severity": "timing",
                        "score": _r(abs(rel)) or 0.0, "delta_s": _r(cw - bw),
                        "detail": (f"node {name!r} wall {bw:.3f}s -> {cw:.3f}s "
                                   f"({rel * 100:+.1f}%){dom_txt}"),
                    })

    def _label(e: dict) -> dict:
        return {
            "label": str(e.get("source") or "entry")
                     + (f" (round {e.get('round')})" if e.get("round") else ""),
            "config_hash": None,
            "backend": e.get("backend"),
            "wall_s": None,
            "generated_unix": e.get("t_unix"),
        }

    return {
        "diagnosis_version": DIAGNOSIS_VERSION,
        "kind": "ledger",
        "backend_class": cls,
        "baseline": _label(baseline),
        "candidate": _label(candidate),
        "wall_delta_s": None,
        "executor_change": None,
        "nodes": nodes_out,
        "programs": None,
        "cache": None,
        "env": None,
        "fields": fields_out or None,
        "attributions": _rank(attributions),
    }


# -- live doctor summary (flight recorder / /statusz) ---------------------

def live_node_summary(baseline_manifest: Optional[dict],
                      finished: Dict[str, dict],
                      active: Optional[Dict[str, dict]] = None) -> Optional[dict]:
    """Compare THIS run's per-node attribution against the last completed
    run's manifest at the same output path.

    ``finished`` is ``obs.devprof.results()``; ``active`` the in-flight
    frame snapshots.  Returns a compact summary (``None`` when no
    baseline devprof exists) that ``obs.flight.build_snapshot`` embeds
    under ``doctor`` — so ``/statusz`` answers "what is slow right now
    vs the last clean run" without a postmortem.  Never raises on odd
    shapes; the caller guards the rest."""
    base_dev = (baseline_manifest or {}).get("devprof") or {}
    if not base_dev:
        return None
    nodes: Dict[str, dict] = {}
    slow: List[str] = []
    for name, cur in sorted((finished or {}).items()):
        if not isinstance(cur, dict):
            continue
        bw = (base_dev.get(name) or {}).get("wall_s")
        cw = cur.get("wall_s")
        delta = (_r(cw - bw)
                 if isinstance(bw, (int, float)) and isinstance(cw, (int, float))
                 else None)
        dominant = None
        vals = {k: float(cur.get(k) or 0.0) for k in PHASE_KEYS}
        if any(v > 0 for v in vals.values()):
            dominant = max(PHASE_KEYS, key=lambda k: (vals[k], k))
        slower = (delta is not None
                  and delta > max(0.05, 0.25 * float(bw)))
        nodes[name] = {"wall_s": _r(cw), "baseline_wall_s": _r(bw),
                       "wall_delta_s": delta, "dominant_phase": dominant,
                       "in_flight": False, "slower": bool(slower)}
        if slower:
            slow.append(name)
    for name, fr in sorted((active or {}).items()):
        if not isinstance(fr, dict) or name in nodes:
            continue
        bw = (base_dev.get(name) or {}).get("wall_s")
        el = fr.get("elapsed_s")
        overdue = (isinstance(bw, (int, float)) and isinstance(el, (int, float))
                   and el > max(0.05, 2.0 * float(bw)))
        nodes[name] = {"wall_s": _r(el), "baseline_wall_s": _r(bw),
                       "wall_delta_s": None, "dominant_phase": None,
                       "in_flight": True, "slower": bool(overdue)}
        if overdue:
            slow.append(name)
    if not nodes:
        return None
    return {
        "baseline_generated_unix": (baseline_manifest or {}).get("generated_unix"),
        "baseline_config_hash": (baseline_manifest or {}).get("config_hash"),
        "nodes": nodes,
        "slow": sorted(slow),
    }


# -- rendering / validation ----------------------------------------------

def render_text(diagnosis: dict, top: int = 3) -> List[str]:
    """Human-facing attribution lines, most severe first."""
    out = []
    for a in (diagnosis.get("attributions") or [])[: top or None]:
        out.append(f"#{a['rank']} [{a['kind']}:{a['subject']}] {a['detail']}")
    return out


def find_manifest(path: str) -> str:
    """Resolve a manifest file from a path the CLI was handed: the file
    itself, a run dir containing ``obs/run_manifest.json``, or the obs
    dir containing ``run_manifest.json``."""
    import os

    if os.path.isfile(path):
        return path
    for cand in (os.path.join(path, "obs", "run_manifest.json"),
                 os.path.join(path, "run_manifest.json")):
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(
        f"no run_manifest.json under {path!r} (expected the file, a run dir "
        "with obs/run_manifest.json, or the obs dir itself)")


_TOP_KEYS = ("diagnosis_version", "kind", "backend_class", "baseline",
             "candidate", "wall_delta_s", "executor_change", "nodes",
             "programs", "cache", "env", "fields", "attributions")
_ATTR_KEYS = ("rank", "kind", "subject", "severity", "score", "delta_s", "detail")


def validate_diagnosis(diagnosis: dict) -> List[str]:
    """Schema check (module-docstring contract); returns error strings,
    empty when valid — the ``--self-check`` gate and tests assert []."""
    errs: List[str] = []
    if not isinstance(diagnosis, dict):
        return ["diagnosis is not a dict"]
    for k in _TOP_KEYS:
        if k not in diagnosis:
            errs.append(f"missing top-level key {k!r}")
    if diagnosis.get("diagnosis_version") != DIAGNOSIS_VERSION:
        errs.append(f"diagnosis_version != {DIAGNOSIS_VERSION}")
    if diagnosis.get("kind") not in ("manifest", "ledger"):
        errs.append(f"kind must be manifest|ledger, got {diagnosis.get('kind')!r}")
    if diagnosis.get("backend_class") not in ("cpu", "accel", "unknown"):
        errs.append(f"bad backend_class {diagnosis.get('backend_class')!r}")
    for side in ("baseline", "candidate"):
        s = diagnosis.get(side)
        if not isinstance(s, dict) or "label" not in s:
            errs.append(f"{side} must be a dict with a label")
    attrs = diagnosis.get("attributions")
    if not isinstance(attrs, list):
        errs.append("attributions must be a list")
        attrs = []
    for i, a in enumerate(attrs):
        if not isinstance(a, dict):
            errs.append(f"attribution {i} is not a dict")
            continue
        for k in _ATTR_KEYS:
            if k not in a:
                errs.append(f"attribution {i} missing {k!r}")
        if a.get("rank") != i + 1:
            errs.append(f"attribution {i} rank {a.get('rank')} != {i + 1}")
        if a.get("severity") not in _SEVERITY_RANK:
            errs.append(f"attribution {i} bad severity {a.get('severity')!r}")
        if not isinstance(a.get("score"), (int, float)) or a.get("score") < 0:
            errs.append(f"attribution {i} score must be a non-negative number")
        if not isinstance(a.get("detail"), str) or not a.get("detail"):
            errs.append(f"attribution {i} detail must be a non-empty string")
    for i in range(1, len(attrs)):
        a, b = attrs[i - 1], attrs[i]
        ka = (_SEVERITY_RANK.get(a.get("severity"), 3), -float(a.get("score") or 0))
        kb = (_SEVERITY_RANK.get(b.get("severity"), 3), -float(b.get("score") or 0))
        if ka > kb:
            errs.append(f"attributions {i - 1}/{i} out of severity/score order")
    return errs


# -- the CLI (python -m anovos_tpu_torch.obs.diffing) -----------------------

SELF_CHECK_BASELINE = "BENCH_r04.json"
SELF_CHECK_CANDIDATE = "BENCH_r05.json"


def _load_manifest(path: str) -> dict:
    with open(find_manifest(path)) as f:
        return json.load(f)


def _select_entry(entries: List[dict], sel: str) -> dict:
    """A ledger entry by source name, content id, round number or index."""
    for e in entries:
        if e.get("source") == sel or e.get("id") == sel:
            return e
    if sel.lstrip("-").isdigit():
        n = int(sel)
        rounds = [e for e in entries if e.get("round") == n]
        if rounds:
            return rounds[-1]
        try:
            return entries[n]
        except IndexError:
            pass
    raise SystemExit(f"perf_doctor: no ledger entry matches {sel!r} (sources: "
                     + ", ".join(sorted({str(e.get('source')) for e in entries})) + ")")


def _print_diagnosis(diag: dict, as_json: bool, top: int) -> None:
    if as_json:
        print(canonical(diag))
        return
    b, c = diag["baseline"], diag["candidate"]
    print(f"perf_doctor: {diag['kind']} diff — {b['label']} -> {c['label']} "
          f"(backend class {diag['backend_class']})")
    if diag.get("wall_delta_s") is not None:
        print(f"  wall: {b.get('wall_s')}s -> {c.get('wall_s')}s ({diag['wall_delta_s']:+.3f}s)")
    lines = render_text(diag, top=top)
    if not lines:
        print("  no attributable movement (runs are equivalent within noise)")
    for line in lines:
        print("  " + line)
    n_extra = len(diag.get("attributions") or []) - len(lines)
    if n_extra > 0:
        print(f"  ... {n_extra} more attribution(s) (--top 0 for all, --json for the full diagnosis)")


def _ledger_entries(path: Optional[str]) -> List[dict]:
    from anovos_tpu_torch.obs.ledger import ledger_path, load

    path = path or ledger_path()
    if not path:
        raise SystemExit("perf_doctor: no ledger: pass --ledger or set ANOVOS_PERF_LEDGER")
    return load(path)


def self_check(ledger: Optional[str] = None) -> int:
    """The ledger's BENCH_r04 -> BENCH_r05 hop, diffed twice: a
    byte-identical, schema-valid, non-empty diagnosis, or exit 1."""
    entries = _ledger_entries(ledger)
    try:
        base = _select_entry(entries, SELF_CHECK_BASELINE)
        cand = _select_entry(entries, SELF_CHECK_CANDIDATE)
        d1, d2 = diff_ledger_entries(base, cand), diff_ledger_entries(base, cand)
    except (SystemExit, DiffRefused) as e:
        print(f"perf_doctor: self-check FAILED — {e}", file=sys.stderr)
        return 1
    b1 = canonical(d1)
    errs = validate_diagnosis(d1)
    if b1 != canonical(d2):
        errs.append("double run was not byte-identical (non-deterministic diagnosis)")
    if not d1.get("attributions"):
        errs.append("r04 -> r05 produced an empty diagnosis")
    if errs:
        print("perf_doctor: self-check FAILED:\n  " + "\n  ".join(errs), file=sys.stderr)
        return 1
    print(f"perf_doctor: self-check ok — {SELF_CHECK_BASELINE} -> {SELF_CHECK_CANDIDATE}: "
          f"{len(d1['attributions'])} attribution(s), deterministic ({len(b1)} canonical bytes), "
          "schema-valid")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """``tools/perf_doctor.py``'s arguments and exit codes: 0 a diagnosis
    (or a passed self-check), 1 refused or failed (a cross-backend-class
    pair is refused), 2 a usage error."""
    ap = argparse.ArgumentParser(prog="python -m anovos_tpu_torch.obs.diffing",
                                 description="structural run-diff with ranked regression attribution")
    ap.add_argument("manifests", nargs="*", help="two manifest files / run dirs (positional form)")
    ap.add_argument("--baseline", help="baseline manifest file or run dir")
    ap.add_argument("--candidate", help="candidate manifest file or run dir")
    ap.add_argument("--ledger", help="perf ledger file for --entry-* and --self-check "
                                     "(default: ANOVOS_PERF_LEDGER)")
    ap.add_argument("--entry-baseline", help="ledger entry: source/round/id/index")
    ap.add_argument("--entry-candidate", help="ledger entry: source/round/id/index")
    ap.add_argument("--self-check", action="store_true",
                    help="a deterministic schema-valid diagnosis of the ledger's r04 -> r05 hop")
    ap.add_argument("--json", action="store_true", help="canonical JSON diagnosis on stdout")
    ap.add_argument("--top", type=int, default=3, help="attribution lines to print (0 = all; default 3)")
    ns = ap.parse_args(argv)

    if ns.self_check:
        return self_check(ns.ledger)
    try:
        if ns.entry_baseline or ns.entry_candidate:
            if not (ns.entry_baseline and ns.entry_candidate):
                ap.error("--entry-baseline and --entry-candidate go together")
            entries = _ledger_entries(ns.ledger)
            base = _select_entry(entries, ns.entry_baseline)
            cand = _select_entry(entries, ns.entry_candidate)
            t0 = time.perf_counter()
            diag = diff_ledger_entries(base, cand)
        else:
            paths = list(ns.manifests)
            if ns.baseline:
                paths.insert(0, ns.baseline)
            if ns.candidate:
                paths.append(ns.candidate)
            if len(paths) != 2:
                ap.error("need exactly two runs: two positional paths, or --baseline + --candidate, "
                         "or --entry-* (ledger mode)")
            base_man, cand_man = _load_manifest(paths[0]), _load_manifest(paths[1])
            t0 = time.perf_counter()
            diag = diff_manifests(base_man, cand_man, baseline_label=paths[0], candidate_label=paths[1])
    except DiffRefused as e:
        print(f"perf_doctor: REFUSED — {e}", file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        print(f"perf_doctor: failed — {e}", file=sys.stderr)
        return 1
    errs = validate_diagnosis(diag)
    if errs:  # the engine's own output contract, enforced on every run
        print("perf_doctor: internal schema violation:\n  " + "\n  ".join(errs), file=sys.stderr)
        return 1
    _print_diagnosis(diag, ns.json, ns.top)
    if not ns.json:
        print(f"perf_doctor: diagnosed in {time.perf_counter() - t0:.3f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
