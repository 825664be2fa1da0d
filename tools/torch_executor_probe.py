"""Split the port's concurrent runner on the card: ``chip_smoke.py``
phase 9's configs_basic input (1,000,000 rows, a 1,000,000-row avro join
side) through ``anovos_tpu_torch.workflow.main`` in several executor
variants in one process, each printing its wall, the join's ETL and
``join_dataset`` seconds, the new caching-allocator segments and the
reserved device memory:

    python tools/torch_executor_probe.py            # the executor variants
    python tools/torch_executor_probe.py --side-read

``--side-read`` times the join side's ``read_dataset`` alone, and plain
uploads, downloads and small syncs, on the default stream and on a side
stream, each from a new thread.  Run from the repository root on a
machine with an NVIDIA GPU.
"""

import argparse
import contextlib
import os
import shutil
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

VARIANTS = [("sequential", "sequential", False), ("concurrent", "concurrent", False),
            ("concurrent again", "concurrent", False), ("concurrent, default stream", "concurrent", True),
            ("sequential again", "sequential", False), ("concurrent, 3rd", "concurrent", False),
            ("concurrent, 4th", "concurrent", False)]


def executor_variants(main_dir: str, join_dir: str, root: str) -> None:
    from anovos_tpu_torch import workflow
    from anovos_tpu_torch.data_ingest import data_ingest
    from anovos_tpu_torch.parallel import scheduler

    parts = []

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            parts.append((name, time.perf_counter() - t0))
            return out
        return call

    workflow.ETL = timed("ETL", workflow.ETL)
    data_ingest.join_dataset = timed("join_dataset()", data_ingest.join_dataset)
    real_scope = scheduler.DagScheduler._node_scope
    try:
        for i, (what, mode, default_stream) in enumerate(VARIANTS):
            scheduler.DagScheduler._node_scope = (
                (lambda self, node: contextlib.nullcontext()) if default_stream else real_scope)
            seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
            with cs.executor(mode):
                run = cs.run_measured(torch, cs.basic_config(main_dir, join_dir), os.path.join(root, f"run{i}"))
            seg = torch.cuda.memory_stats().get("segment.all.allocated", 0) - seg0
            bt = run["block_times_s"]
            print(f"{what}: workflow.main {run['wall_s']:.3f} s, scheduler wall {run['schedule']['wall_s']:.3f} s, "
                  f"join {bt['join_dataset']:.3f} s, report {bt['Basic Report']:.3f} s, new cudaMalloc segments "
                  f"{seg}, reserved {torch.cuda.memory_reserved() / 2**20:.0f} MiB, on streams "
                  f"{len(run['schedule']['on_stream'])}; " + ", ".join(f"{n} {t:.3f}" for n, t in parts),
                  flush=True)
            parts.clear()
            shutil.rmtree(os.path.join(root, f"run{i}"))
    finally:
        scheduler.DagScheduler._node_scope = real_scope


def side_read(join_dir: str) -> None:
    from anovos_tpu_torch.data_ingest import data_ingest

    side = torch.cuda.Stream()
    x = np.arange(1_000_000, dtype=np.int64)
    tests = {
        "read_dataset(avro side)": lambda: data_ingest.read_dataset(join_dir, "avro"),
        "upload 1M int64 x24": lambda: [torch.from_numpy(x).to("cuda") for _ in range(24)],
        "download 1M int64 x24": lambda: [t.cpu() for t in [torch.arange(1_000_000, device="cuda")] * 24],
        "2000 small .item()": lambda: [torch.ones(4, device="cuda").sum().item() for _ in range(2000)],
    }

    def on_thread(stream, fn) -> float:
        out = {}

        def run():
            with (torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()):
                t0 = time.perf_counter()
                fn()
                torch.cuda.current_stream().synchronize()
                out["t"] = time.perf_counter() - t0

        th = threading.Thread(target=run)
        th.start()
        th.join()
        return out["t"]

    for rep in range(2):
        for name, fn in tests.items():
            for tag, stream in (("default", None), ("side", side)):
                print(f"rep {rep} {name} on the {tag} stream: {on_thread(stream, fn):.3f} s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side-read", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this probe needs an NVIDIA GPU")
    from anovos_tpu_torch.ops.kernels import build
    from anovos_tpu_torch.shared import native
    from anovos_tpu_torch.shared.runtime import init_runtime

    init_runtime("cuda")
    build.load()
    native.load()
    root = tempfile.mkdtemp(prefix="anovos_probe_")
    try:
        _, _, main_dir, join_dir = cs.runner_inputs(torch, 0, root)
        if args.side_read:
            side_read(join_dir)
        else:
            executor_variants(main_dir, join_dir, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()
