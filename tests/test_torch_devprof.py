"""The port's device-time attribution (``anovos_tpu_torch.obs.devprof``),
case by case as ``tests/test_devprof.py`` holds the JAX package's:

* unit semantics: dispatch nesting (outermost wins), transfer byte/wall
  booking, the drain, attribution clamping;
* the invariant: every executed node of a workflow run carries a
  manifest ``devprof`` entry with ``device + dispatch + transfer + host ≤
  wall ≤ node dur``;
* device-memory sampling: ``record_device_memory`` labels every card
  (``torch.cuda.memory_stats`` monkeypatched: there is no card here) and
  keeps the sum's high-water; nothing on a CPU runtime;
* stability: the ``devprof`` section and its metric families are
  stripped by ``stable_view``.

The JAX drain probe times a trivial program's ``block_until_ready``; the
port's drain is the timed ``synchronize()`` of the node's stream, so the
probe cases hold a fake stream's sync instead.
"""

import copy
import threading
import time

import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)
from anovos_tpu_torch import obs
from anovos_tpu_torch.obs import devprof
from anovos_tpu_torch.obs.metrics import MetricsRegistry, record_device_memory


# ---------------------------------------------------------------------------
# unit: brackets
# ---------------------------------------------------------------------------

def test_node_bracket_produces_invariant_result():
    devprof.reset()
    with devprof.node_bracket("n1"):
        with devprof.dispatch_bracket("ops.fake"):
            pass
        devprof.record_transfer("h2d", 1024, 0.001, label="test")
    out = devprof.results()["n1"]
    total = out["device_time_s"] + out["dispatch_s"] + out["transfer_s"] + out["host_s"]
    assert total <= out["wall_s"] + 1e-9
    assert out["h2d_bytes"] == 1024
    assert out["d2h_bytes"] == 0
    assert out["transfers"] == 1
    assert out["last_op"] in ("test", "ops.fake")


def test_dispatch_bracket_outermost_only():
    devprof.reset()
    with devprof.node_bracket("nested"):
        with devprof.dispatch_bracket("outer"):
            with devprof.dispatch_bracket("inner"):
                pass
    assert devprof.results()["nested"]["dispatches"] == 1


def test_dispatch_compile_phase_not_booked_as_dispatch():
    devprof.reset()
    with devprof.node_bracket("cold"):
        with devprof.dispatch_bracket("ops.x", phase="compile"):
            pass
    out = devprof.results()["cold"]
    assert out["dispatches"] == 0
    assert out["last_op"] == "ops.x"


def test_transfer_bracket_books_bytes_and_direction():
    devprof.reset()
    before = obs.get_metrics().counter("transfer_h2d_bytes_total").value()
    with devprof.node_bracket("t"):
        with devprof.transfer_bracket("h2d", 100, label="up"):
            pass
        with devprof.transfer_bracket("d2h", 200, label="down"):
            pass
    out = devprof.results()["t"]
    assert out["h2d_bytes"] == 100 and out["d2h_bytes"] == 200
    assert obs.get_metrics().counter("transfer_h2d_bytes_total").value() == before + 100


def test_record_transfer_rejects_bad_direction():
    with pytest.raises(ValueError):
        devprof.record_transfer("sideways", 1, 0.0)


def test_transfer_outside_node_counts_globally_only():
    devprof.reset()
    before = obs.get_metrics().counter("transfer_d2h_bytes_total").value()
    devprof.record_transfer("d2h", 64, 0.0, label="orphan")
    assert obs.get_metrics().counter("transfer_d2h_bytes_total").value() == before + 64
    assert devprof.results() == {}


def test_clamp_when_components_exceed_wall(monkeypatch):
    """A drain longer than the node wall itself is scaled down, never
    breaking the invariant."""
    devprof.reset()
    monkeypatch.setattr(devprof, "_drain_wall", lambda stream=None: 3600.0)
    monkeypatch.setattr(devprof, "_PROBE_FLOOR", 0.0)
    with devprof.node_bracket("clamped"):
        pass
    out = devprof.results()["clamped"]
    assert out["clamped"] is True
    total = out["device_time_s"] + out["dispatch_s"] + out["transfer_s"] + out["host_s"]
    assert total <= out["wall_s"] + 1e-9


def test_disabled_via_env(monkeypatch):
    monkeypatch.setenv("ANOVOS_TPU_DEVPROF", "0")
    devprof.reset()
    with devprof.node_bracket("off") as frame:
        assert frame is None
    assert devprof.results() == {}


def test_active_frames_visible_mid_node():
    devprof.reset()
    with devprof.node_bracket("live"):
        with devprof.dispatch_bracket("ops.mid"):
            pass
        seen = devprof.active_frames()
    assert "live" in seen
    assert seen["live"]["last_op"] == "ops.mid"
    assert devprof.active_frames() == {}


def test_timed_ops_feed_the_active_frame():
    """A timed op called under a node bracket books dispatch wall there on
    its second call at a signature (the first is the compile phase)."""
    from anovos_tpu_torch.obs.timed import timed

    @timed("ops.probe_op")
    def op(x):
        return x

    devprof.reset()
    op(1)
    with devprof.node_bracket("with_op"):
        op(1)
    out = devprof.results()["with_op"]
    assert out["dispatches"] == 1
    assert out["last_op"] == "ops.probe_op"


def test_timed_fires_on_warm_calls_of_a_port_op():
    """The port's ops carry their JAX labels, and a warm call books a
    steady-state call under it."""
    import torch

    from anovos_tpu_torch.ops.datetime_kernels import extract_unit

    secs = torch.arange(8, dtype=torch.int32)
    before = obs.get_metrics().counter("op_cache_hit_total").value(op="ops.extract_unit")
    extract_unit(secs, "day")
    extract_unit(secs, "day")
    after = obs.get_metrics().counter("op_cache_hit_total").value(op="ops.extract_unit")
    assert after >= before + 1


def test_record_transfer_quiet_when_disabled(monkeypatch):
    monkeypatch.setenv("ANOVOS_TPU_DEVPROF", "0")
    before = obs.get_metrics().counter("transfer_d2h_bytes_total").value()
    devprof.record_transfer("d2h", 4096, 0.0, label="disabled")
    assert obs.get_metrics().counter("transfer_d2h_bytes_total").value() == before


def test_node_bracket_drain_false_attributes_zero_device():
    devprof.reset()
    with devprof.node_bracket("nodrain", drain=False):
        devprof.drain_stream(_FakeStream(0.02), book=True)
    assert devprof.results()["nodrain"]["device_time_s"] == 0.0


# ---------------------------------------------------------------------------
# the drain (a stream sync)
# ---------------------------------------------------------------------------

class _FakeStream:
    """A stream whose sync takes ``secs`` (or raises ``error``)."""

    def __init__(self, secs=0.0, error=None):
        self.secs, self.error, self.syncs = secs, error, 0

    def synchronize(self):
        self.syncs += 1
        if self.error is not None:
            raise self.error
        time.sleep(self.secs)


def test_drain_on_a_cpu_runtime_is_zero_and_syncs_nothing():
    devprof.reset()
    assert devprof._PROBE_FLOOR == 0.0
    assert devprof._drain_wall() == 0.0


def test_drain_stream_books_the_sync_less_the_floor(monkeypatch):
    """The scheduler's stream sync is the node's device time: one sync,
    booked once, less the floor."""
    devprof.reset()
    monkeypatch.setattr(devprof, "_PROBE_FLOOR", 0.005)
    stream = _FakeStream(0.03)
    with devprof.node_bracket("drained"):
        devprof.drain_stream(stream)
    out = devprof.results()["drained"]
    assert stream.syncs == 1
    assert 0.02 <= out["device_time_s"] <= out["wall_s"]


def test_drain_error_propagates():
    """A CUDA error surfacing at the sync fails the node: it propagates
    out of the drain and the bracket, and the stream was synced once."""
    devprof.reset()
    stream = _FakeStream(error=RuntimeError("CUDA error: an illegal memory access"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with devprof.node_bracket("bad"):
            devprof.drain_stream(stream)
    assert stream.syncs == 1
    assert "bad" in devprof.results()


def test_unbooked_drain_still_syncs():
    """With ``book=False`` the scheduler's sync still happens (it is the
    scheduler's), and books nothing."""
    devprof.reset()
    stream = _FakeStream(0.01)
    with devprof.node_bracket("unbooked", drain=False):
        devprof.drain_stream(stream, book=False)
    assert stream.syncs == 1
    assert devprof.results()["unbooked"]["device_time_s"] == 0.0


# ---------------------------------------------------------------------------
# workflow integration: the invariant
# ---------------------------------------------------------------------------

@pytest.fixture()
def small_run(tmp_path, monkeypatch):
    from tools.chaos_run import synthetic_config

    from anovos_tpu_torch import workflow

    cfg = synthetic_config(str(tmp_path))
    rundir = tmp_path / "run"
    rundir.mkdir()
    monkeypatch.chdir(rundir)
    monkeypatch.delenv("ANOVOS_TPU_CHAOS", raising=False)
    monkeypatch.setenv("ANOVOS_TPU_EXECUTOR", "sequential")
    workflow.main(copy.deepcopy(cfg), "local")
    return obs.load_manifest(workflow.LAST_MANIFEST_PATH)


def test_every_executed_node_has_devprof_entry(small_run):
    man = small_run
    dev = man.get("devprof") or {}
    nodes = man["scheduler"]["nodes"]
    executed = [n for n, nd in nodes.items() if nd.get("state") == "done" and nd.get("dur_s") is not None]
    assert executed
    for name in executed:
        entry = dev.get(name)
        assert entry, f"executed node {name!r} has no devprof entry"
        total = entry["device_time_s"] + entry["dispatch_s"] + entry["transfer_s"] + entry["host_s"]
        assert total <= entry["wall_s"] + 1e-6, (name, entry)
        assert entry["wall_s"] <= nodes[name]["dur_s"] + 0.1, (name, entry)
        assert entry["device_time_s"] == 0.0  # a CPU runtime drains nothing


def test_run_books_transfer_bytes(small_run):
    """The run uploads the parquet (h2d) and writes CSV stats (d2h through
    to_pandas): both directions are nonzero."""
    metrics = small_run["metrics"]
    h2d = metrics.get("transfer_h2d_bytes_total", {}).get("series", {})
    d2h = metrics.get("transfer_d2h_bytes_total", {}).get("series", {})
    assert sum(h2d.values()) > 0
    assert sum(d2h.values()) > 0


def test_devprof_stripped_from_stable_view(small_run):
    sv = obs.stable_view(small_run)
    assert "devprof" not in sv
    assert not any(k.startswith("devprof_") or k.startswith("transfer_") for k in sv["metrics"])


# ---------------------------------------------------------------------------
# device memory across every card
# ---------------------------------------------------------------------------

def _fake_cards(monkeypatch, stats):
    """Make the runtime a card and ``torch.cuda`` report ``stats`` (one
    memory_stats dict a card)."""
    import torch

    from anovos_tpu_torch.shared import runtime

    monkeypatch.setattr(runtime, "peek_runtime",
                        lambda: runtime.Runtime(device=torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(stats))
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])


def test_record_device_memory_covers_all_local_devices(monkeypatch):
    stats = [{"allocated_bytes.all.current": (i + 1) * 1000,
              "allocated_bytes.all.peak": (i + 1) * 2000} for i in range(4)]
    _fake_cards(monkeypatch, stats)
    reg = MetricsRegistry()
    record_device_memory(reg)
    assert len(reg.gauge("device_bytes_in_use").series()) == 4
    assert reg.gauge("device_bytes_in_use").value(device="cuda:3") == 4000.0
    assert reg.gauge("device_peak_bytes").value(device="cuda:3") == 8000.0
    assert reg.gauge("device_mesh_bytes_in_use").value() == sum((i + 1) * 1000 for i in range(4))
    hw = reg.gauge("device_mesh_bytes_high_water").value()
    assert hw == reg.gauge("device_mesh_bytes_in_use").value()
    stats[3]["allocated_bytes.all.current"] = 1
    record_device_memory(reg)
    assert reg.gauge("device_mesh_bytes_high_water").value() == hw


def test_record_device_memory_noop_without_stats(monkeypatch):
    """Nothing on a CPU runtime (this one), nor on a card whose allocator
    reports nothing."""
    reg = MetricsRegistry()
    record_device_memory(reg)
    assert reg.snapshot() == {}
    _fake_cards(monkeypatch, [{}])
    record_device_memory(reg)
    assert reg.snapshot() == {}


def test_node_bracket_books_device_memory_delta(monkeypatch):
    stats = [{"allocated_bytes.all.current": 1000, "allocated_bytes.all.peak": 1000}]
    _fake_cards(monkeypatch, stats)
    monkeypatch.setenv("ANOVOS_TPU_DEVPROF", "1")
    with devprof.node_bracket("grow", drain=False):
        stats[0]["allocated_bytes.all.current"] = 5000
    assert devprof.results()["grow"]["hbm_delta_bytes"] == {"cuda:0": 4000}


# ---------------------------------------------------------------------------
# thread-safety: transfers landing from other threads
# ---------------------------------------------------------------------------

def test_frame_accumulation_is_thread_safe():
    devprof.reset()
    with devprof.node_bracket("threads"):
        frame = devprof._ACTIVE["threads"]

        def hammer():
            for _ in range(500):
                frame.add_transfer("h2d", 2, 0.0, "t")
                devprof.record_decode(0.0, 1, frame=frame)

        ts = [threading.Thread(target=hammer) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    out = devprof.results()["threads"]
    assert out["h2d_bytes"] == 4 * 500 * 2
    assert out["transfers"] == 2000
    assert out["decodes"] == 2000 and out["decode_bytes"] == 2000
