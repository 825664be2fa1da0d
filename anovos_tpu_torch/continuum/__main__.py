"""``python -m anovos_tpu_torch.continuum`` — the continuum service CLI
(the flags of ``python -m anovos_tpu.continuum``).

Commands::

    run     poll the dataset directory until stopped (ANOVOS_CONTINUUM_POLL_S
            or --poll seconds between steps; --max-iterations bounds it,
            --stop-file ends the loop when the file appears)
    step    one arrival-loop iteration (scan → fold → finalize → alert →
            snapshot), printing the step summary
    status  feed status from the on-disk state and its journal

The feed config comes from ``--config`` (a workflow YAML's
``continuous_analysis`` section, or a YAML that is the section) with
``--dataset`` / ``--state-dir`` / ``--output`` / ``--file-type``
overrides.  The folds run on the card: without one, the CLI exits at
``init_runtime`` (a caller that set up a runtime first, as the tests do
with ``init_runtime("cpu")``, keeps it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _emit(doc, indent=None) -> None:
    sys.stdout.write(json.dumps(doc, indent=indent, sort_keys=True, default=str) + "\n")
    sys.stdout.flush()


def _load_config(ns):
    from anovos_tpu_torch.continuum.watcher import ContinuumConfig

    section = {}
    base_dir = "."
    if ns.config:
        import yaml

        with open(ns.config) as f:
            doc = yaml.load(f, yaml.SafeLoader) or {}
        section = doc.get("continuous_analysis", doc) or {}
        base_dir = os.path.dirname(os.path.abspath(ns.config))
    if ns.dataset:
        section["dataset_path"] = ns.dataset
    if ns.state_dir:
        section["state_dir"] = ns.state_dir
    if ns.output:
        section["output_path"] = ns.output
    if ns.file_type:
        section["file_type"] = ns.file_type
    return ContinuumConfig.from_dict(section, base_dir=base_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m anovos_tpu_torch.continuum",
        description="continuous incremental feature engineering over a partition-arrival feed")
    ap.add_argument("command", choices=("run", "step", "status"))
    ap.add_argument("--config", help="workflow YAML (continuous_analysis section) or a bare section YAML")
    ap.add_argument("--dataset", help="dataset directory (overrides config)")
    ap.add_argument("--state-dir", help="state directory (overrides config)")
    ap.add_argument("--output", help="artifact directory (overrides config)")
    ap.add_argument("--file-type", help="part file type (default parquet)")
    ap.add_argument("--poll", type=float, default=None,
                    help="poll seconds for `run` (ANOVOS_CONTINUUM_POLL_S wins)")
    ap.add_argument("--max-iterations", type=int, default=None)
    ap.add_argument("--stop-file", default=None, help="`run` exits once this file exists")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ns = ap.parse_args(argv)

    cfg = _load_config(ns)
    if ns.poll is not None:
        cfg.poll_s = ns.poll

    from anovos_tpu_torch.continuum import watcher

    if ns.command == "status":
        result = watcher.status(cfg)
    else:
        from anovos_tpu_torch.shared.runtime import get_runtime

        # the card, unless the caller set up another runtime first
        get_runtime()
        if ns.command == "step":
            result = watcher.step(cfg)
        else:
            steps = watcher.run(cfg, max_iterations=ns.max_iterations, stop_file=ns.stop_file)
            result = {"iterations": len(steps), "last": steps[-1] if steps else None}
    _emit(result, indent=None if ns.json else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
