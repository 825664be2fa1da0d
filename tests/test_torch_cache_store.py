"""The port's node store (``anovos_tpu_torch/cache/store.py``) against the
JAX package's ``CacheStore`` on a payload commit (the continuum's
snapshot, and a spine node's df checkpoint): the same manifest and
on-disk layout, so each package looks up the other's commit; a lost
payload is a miss; a failed payload write commits nothing; the manifest
listing.  File commits, restore and gc: ``tests/test_torch_cache.py``.
"""

import json
import os

import pytest


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def _payload(d, body=b"payload"):
    os.makedirs(os.path.join(d, "parts"))
    with open(os.path.join(d, "parts", "p.npz"), "wb") as f:
        f.write(body)


def test_commit_layout_equals_jax(tmp_path):
    from anovos_tpu.cache.store import CacheStore as JStore
    from anovos_tpu_torch.cache.store import CacheStore

    got = CacheStore(str(tmp_path / "p")).commit("fp1", "node:x", (), payload_write=_payload)
    exp = JStore(str(tmp_path / "j")).commit("fp1", "node:x", paths=(), payload_write=_payload)
    got.pop("created_unix")
    exp.pop("created_unix")
    assert got == exp
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j") == ["nodes/fp1.json", "payloads/fp1/parts/p.npz"]
    with open(tmp_path / "p" / "nodes" / "fp1.json") as f:
        assert json.load(f)["node"] == "node:x"


def test_each_package_looks_up_the_others_commit(tmp_path):
    from anovos_tpu.cache.store import CacheStore as JStore
    from anovos_tpu_torch.cache.store import CacheStore

    root = str(tmp_path / "store")
    CacheStore(root).commit("fp-p", "n", (), payload_write=_payload)
    JStore(root).commit("fp-j", "n", paths=(), payload_write=lambda d: _payload(d, b"jax"))
    for reader, fp, body in ((JStore(root), "fp-p", b"payload"), (CacheStore(root), "fp-j", b"jax")):
        m = reader.lookup(fp)
        assert m is not None and m["fingerprint"] == fp and m["payload"]
        with open(os.path.join(reader.payload_dir(fp), "parts", "p.npz"), "rb") as f:
            assert f.read() == body
    assert [m["fingerprint"] for m in CacheStore(root).manifests()] == ["fp-j", "fp-p"]


def test_lookup_misses_a_lost_payload_and_touches_the_manifest(tmp_path):
    import shutil

    from anovos_tpu_torch.cache.store import CacheStore

    store = CacheStore(str(tmp_path / "s"))
    store.commit("fp", "n", (), payload_write=_payload)
    mpath = tmp_path / "s" / "nodes" / "fp.json"
    os.utime(mpath, (1, 1))
    assert store.lookup("fp") is not None
    assert mpath.stat().st_mtime > 1  # the LRU clock a JAX gc reads
    shutil.rmtree(store.payload_dir("fp"))
    assert store.lookup("fp") is None
    assert store.lookup("never") is None
    (tmp_path / "s" / "nodes" / "bad.json").write_text("{")
    assert store.lookup("bad") is None


def test_failed_payload_write_commits_nothing(tmp_path):
    from anovos_tpu_torch.cache.store import CacheStore

    store = CacheStore(str(tmp_path / "s"))

    def broken(d):
        _payload(d)
        raise RuntimeError("disk full")

    with pytest.raises(RuntimeError):
        store.commit("fp", "n", (), payload_write=broken)
    assert store.lookup("fp") is None and _tree(tmp_path / "s") == []
    store.commit("fp", "n", (), payload_write=_payload)
    store.commit("fp", "n", (), payload_write=lambda d: _payload(d, b"second"))  # a re-commit replaces the payload
    with open(os.path.join(store.payload_dir("fp"), "parts", "p.npz"), "rb") as f:
        assert f.read() == b"second"
    assert _tree(tmp_path / "s") == ["nodes/fp.json", "payloads/fp/parts/p.npz"]


def test_manifests_lists_committed_nodes_like_jax(tmp_path):
    from anovos_tpu.cache.store import CacheStore as JStore
    from anovos_tpu_torch.cache.store import CacheStore

    root = str(tmp_path / "s")
    store = CacheStore(root)
    for fp in ("b", "a", "c"):
        store.commit(fp, f"node:{fp}", (), payload_write=_payload)
    (tmp_path / "s" / "nodes" / "junk.json").write_text("not json")
    (tmp_path / "s" / "nodes" / "notes.txt").write_text("x")
    got = store.manifests()
    assert [m["fingerprint"] for m in got] == ["a", "b", "c"]
    assert got == JStore(root)._load_manifests()
