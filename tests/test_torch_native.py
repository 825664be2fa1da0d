"""The port's host codec (``anovos_tpu_torch/shared/native.py`` over
``shared/csrc/anovos_native.cpp``) against the JAX package's
``anovos_tpu.shared.native`` and against the port's pure-Python Avro
reader and writer, on frames made from a numpy seed: Avro decode under the
null, deflate and snappy codecs, dictionary encoding, Avro block encode,
the union-find components, and the build's failures and rebuilds.

One divergence is pinned: the JAX decoder returns every int and long field
as float64, so a ``long`` past 2^53 loses bits there; the port's is exact
(ROADMAP Queue C)."""

import io
import json
import shutil
import zlib

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from _torch_port import torch_cpu_runtime  # noqa: F401  (autouse fixture)

WIDE = 2**53 + 1  # the first int64 float64 cannot hold
NON_ASCII = ["é", "ü", "中文", "日本語", "😀", "Z", "a", "", "ß", "Ω", "é"]


# ---------------------------------------------------------------------------
# a container writer for any schema of primitive fields (the port's writers
# put the value branch first; these files test both orders)


def _long(out, v: int) -> None:
    v = (v << 1) ^ (v >> 63)
    while True:
        b, v = v & 0x7F, v >> 7
        out.write(bytes([b | 0x80]) if v else bytes([b]))
        if not v:
            break


def _value(out, v, t: str) -> None:
    if t == "string":
        b = v.encode("utf-8")
        _long(out, len(b))
        out.write(b)
    elif t in ("int", "long"):
        _long(out, int(v))
    elif t == "float":
        out.write(np.float32(v).tobytes())
    elif t == "double":
        out.write(np.float64(v).tobytes())
    elif t == "boolean":
        out.write(b"\x01" if v else b"\x00")
    elif t == "bytes":
        _long(out, len(v))
        out.write(v)
    else:
        raise ValueError(t)


def _compress(data: bytes, codec: str) -> bytes:
    if codec == "null":
        return data
    if codec == "deflate":
        c = zlib.compressobj(wbits=-15)
        return c.compress(data) + c.flush()
    if codec == "snappy":
        comp = pa.Codec("snappy").compress(data, asbytes=True)
        return comp + zlib.crc32(data).to_bytes(4, "big")
    raise ValueError(codec)


def write_container(path: str, fields: list, cols: dict, codec: str, block_rows: int = 97,
                    sync: bytes = b"0123456789abcdef") -> None:
    """``fields``: Avro field dicts; ``cols``: name → list of values (None
    null)."""
    out = io.BytesIO()
    out.write(b"Obj\x01")
    meta = {"avro.schema": json.dumps({"type": "record", "name": "r", "fields": fields}).encode(),
            "avro.codec": codec.encode()}
    _long(out, len(meta))
    for k, v in meta.items():
        _long(out, len(k))
        out.write(k.encode())
        _long(out, len(v))
        out.write(v)
    _long(out, 0)
    out.write(sync)
    n = len(next(iter(cols.values())))
    for start in range(0, n, block_rows):
        stop = min(n, start + block_rows)
        block = io.BytesIO()
        for i in range(start, stop):
            for f in fields:
                v, t = cols[f["name"]][i], f["type"]
                if isinstance(t, list):
                    branch = t.index("null") if v is None else 1 - t.index("null")
                    _long(block, branch)
                    if v is None:
                        continue
                    t = t[branch]
                _value(block, v, t)
        data = _compress(block.getvalue(), codec)
        _long(out, stop - start)
        _long(out, len(data))
        out.write(data)
        out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())


def edge_frame(n: int, seed: int):
    """Fields covering the codec's types and edges, and their values."""
    g = np.random.default_rng(seed)
    words = np.array(NON_ASCII + [f"w{i}" for i in range(40)], dtype=object)

    def maybe(vals, p):
        return [None if g.random() < p else v for v in vals]

    cols = {
        "s_null_last": maybe(list(g.choice(words, n)), 0.2),
        "s_null_first": maybe(list(g.choice(words, n)), 0.1),
        "s_plain": list(g.choice(words, n)),
        "s_all_null": [None] * n,
        "s_numeric": maybe([str(x) for x in g.integers(-500, 500, n)], 0.1),
        "b_nullable": maybe([bool(x) for x in g.integers(0, 2, n)], 0.3),
        "b_plain": [bool(x) for x in g.integers(0, 2, n)],
        "i_nullable": maybe([int(x) for x in g.integers(-2**31, 2**31, n)], 0.2),
        "l_wide": [WIDE + int(x) for x in g.integers(0, 1000, n)],
        "l_neg": [int(x) for x in g.integers(-2**52, 2**52, n)],
        "f_float": maybe([float(x) for x in g.normal(0, 1e3, n)], 0.1),
        "d_double": maybe([float(x) for x in g.normal(0, 1e10, n)], 0.15),
        "d_all_null": [None] * n,
    }
    fields = [
        {"name": "s_null_last", "type": ["string", "null"]},
        {"name": "s_null_first", "type": ["null", "string"]},
        {"name": "s_plain", "type": "string"},
        {"name": "s_all_null", "type": ["string", "null"]},
        {"name": "s_numeric", "type": ["null", "string"]},
        {"name": "b_nullable", "type": ["null", "boolean"]},
        {"name": "b_plain", "type": "boolean"},
        {"name": "i_nullable", "type": ["int", "null"]},
        {"name": "l_wide", "type": "long"},
        {"name": "l_neg", "type": ["null", "long"]},
        {"name": "f_float", "type": ["float", "null"]},
        {"name": "d_double", "type": ["null", "double"]},
        {"name": "d_all_null", "type": ["double", "null"]},
    ]
    return fields, cols


def _objects(col):
    return list(col.to_object_array()) if hasattr(col, "to_object_array") else list(col)


@pytest.mark.parametrize("codec", ["null", "deflate", "snappy"])
def test_decode_matches_jax_and_the_python_reader(tmp_path, codec):
    from anovos_tpu.data_ingest import avro_io as javro
    from anovos_tpu_torch.data_ingest import avro_io
    from anovos_tpu_torch.shared.native import NativeEncodedStrings

    fields, cols = edge_frame(1000, seed={"null": 1, "deflate": 2, "snappy": 3}[codec])
    path = str(tmp_path / "edge.avro")
    write_container(path, fields, cols, codec)
    got, ref, jax = avro_io.read_avro(path), avro_io.read_avro_records(path), javro.read_avro(path)
    assert list(got) == list(ref) == list(jax) == [f["name"] for f in fields]
    for name, g in got.items():
        if name.startswith("s_"):
            assert isinstance(g, NativeEncodedStrings), name
            assert g.codes.dtype == np.int32
            np.testing.assert_array_equal(g.codes, jax[name].codes, err_msg=name)
            assert list(g.vocab) == list(jax[name].vocab), name
            assert _objects(g) == list(ref[name]) == _objects(jax[name]), name
            present = sorted({v for v in cols[name] if v is not None})
            assert list(g.vocab) == present, name  # "" kept, code-point order
        elif name == "l_wide":
            # exact in the port and the Python reader; the JAX decoder goes
            # through float64 and loses the low bit (ROADMAP Queue C)
            assert g.dtype == np.int64 and ref[name].dtype == np.int64
            np.testing.assert_array_equal(g, np.array(cols[name], np.int64))
            np.testing.assert_array_equal(ref[name], g)
            assert jax[name].dtype == np.int64
            assert (jax[name] != g).any()
            np.testing.assert_array_equal(jax[name], g.astype(np.float64).astype(np.int64))
        else:
            assert g.dtype == jax[name].dtype == ref[name].dtype, name
            np.testing.assert_array_equal(g, jax[name], err_msg=name)
            np.testing.assert_array_equal(g, ref[name], err_msg=name)
    assert got["b_nullable"].dtype == bool and not got["b_nullable"][
        [v is None for v in cols["b_nullable"]]].any()  # boolean nulls collapse to False
    assert got["i_nullable"].dtype == np.float64 and np.isnan(got["i_nullable"]).sum() > 0
    assert got["l_neg"].dtype == np.int64
    assert np.isnan(got["d_all_null"]).all() and len(got["s_all_null"].vocab) == 0


def test_read_dataset_avro_matches_jax(tmp_path):
    """The codec's columns through ``read_dataset``: numeric strings parsed
    from the vocabulary, the same Tables as the JAX package's (the wide
    long column left out: pinned above)."""
    from anovos_tpu.data_ingest.data_ingest import read_dataset as jread
    from anovos_tpu_torch.data_ingest.data_ingest import read_dataset

    fields, cols = edge_frame(700, seed=5)
    keep = [f for f in fields if f["name"] != "l_wide"]
    d = tmp_path / "avro"
    d.mkdir()
    write_container(str(d / "part-00000.avro"), keep, cols, "deflate")
    write_container(str(d / "part-00001.avro"), keep, edge_frame(300, seed=6)[1], "snappy")
    got, exp = read_dataset(str(d), "avro"), jread(str(d), "avro")
    assert got.dtypes() == exp.dtypes()
    assert dict(got.dtypes())["s_numeric"] == "double"
    pd.testing.assert_frame_equal(got.to_pandas(), exp.to_pandas())


# ---------------------------------------------------------------------------
# dictionary encoding


def _np_unique_codes(vals):
    """The str() + np.unique route: (codes with −1 null, vocab)."""
    vals = np.asarray(vals, dtype=object)
    isnull = pd.isna(vals)
    vocab, codes = np.unique(np.array([str(v) for v in vals[~isnull]], dtype=object),
                             return_inverse=True)
    out = np.full(len(vals), -1, np.int32)
    out[~isnull] = codes
    return out, list(vocab)


def _string_inputs(seed: int):
    g = np.random.default_rng(seed)
    base = np.array(NON_ASCII + [f"k{i:03d}" for i in range(200)], dtype=object)
    vals = g.choice(base, 3000).astype(object)
    vals[g.random(3000) < 0.1] = None
    vals[g.random(3000) < 0.05] = np.nan
    chunked = pa.chunked_array([pa.array(vals[:1000], pa.string(), from_pandas=True),
                                pa.array(vals[1000:], pa.string(), from_pandas=True)])
    return {
        "object": vals,
        "pandas_str": pd.Series(vals, dtype="str").array,
        "pandas_arrow": pd.Series(vals, dtype="string[pyarrow]").array,
        "numpy_unicode": np.array([v for v in vals if isinstance(v, str)]),
        "arrow_chunked_slice": chunked.slice(17, 2900),
    }


@pytest.mark.parametrize("kind", ["object", "pandas_str", "pandas_arrow", "numpy_unicode",
                                  "arrow_chunked_slice"])
def test_dict_encode_matches_np_unique_and_jax(kind):
    from anovos_tpu.shared import native as jnative
    from anovos_tpu_torch.shared import native

    vals = _string_inputs(11)[kind]
    enc = native.dict_encode_strings(vals)
    assert enc is not None
    host = np.array(vals.to_pylist() if isinstance(vals, pa.ChunkedArray) else list(vals), dtype=object)
    codes, vocab = _np_unique_codes(host)
    np.testing.assert_array_equal(enc.codes, codes)
    assert list(enc.vocab) == vocab and "" in vocab and "😀" in vocab
    data, offsets, valid = native.string_buffers(vals)
    jenc = jnative._dict_encode_buffers(jnative.get_native(), data, offsets, valid, len(valid))
    np.testing.assert_array_equal(jenc.codes, enc.codes)
    assert list(jenc.vocab) == list(enc.vocab)


def test_other_objects_keep_the_str_route():
    """Object columns holding anything but str and nulls (numbers, bytes,
    strings that are not UTF-8) are not string buffers; ``host_to_column``
    gives them the str() + np.unique encoding, as the JAX package does."""
    from anovos_tpu.shared.table import Table as JTable
    from anovos_tpu_torch.shared import native
    from anovos_tpu_torch.shared.table import Table

    cols = {
        "mixed": np.array(["a", 1, 2.5, None, "b", True], dtype=object),
        "bytes": np.array([b"x", "x", None, b"y", "z", "x"], dtype=object),
        "surrogate": np.array(["\ud800", "a", None, "\udfff", "a", "b"], dtype=object),
        "category": pd.Categorical(["u", "v", None, "u", "w", "v"]),
    }
    for name in ("mixed", "bytes", "surrogate"):
        assert native.string_buffers(cols[name]) is None, name
    df = pd.DataFrame({k: v if k == "category" else pd.Series(v, dtype=object) for k, v in cols.items()})
    got, exp = Table.from_pandas(df, device="cpu"), JTable.from_pandas(df)
    for name in cols:
        codes, vocab = _np_unique_codes(df[name].to_numpy(dtype=object))
        np.testing.assert_array_equal(got.columns[name].data.numpy(), codes, err_msg=name)
        assert list(got.columns[name].vocab) == vocab == list(exp.columns[name].vocab), name
        np.testing.assert_array_equal(np.asarray(exp.columns[name].data)[:len(df)], codes)


def test_invalid_utf8_vocabulary_is_merged(tmp_path):
    """Bytes that are not UTF-8 decode with replacement characters, so two
    byte strings can decode alike.  The port merges them into one sorted
    entry; the JAX bridge keeps both entries, a vocabulary with a duplicate
    (ROADMAP Queue C)."""
    from anovos_tpu.shared import native as jnative
    from anovos_tpu_torch.shared import native

    words = [b"\xff", b"b", b"\xfe", b"a", b"\xff", b"", b"\xc3\xa9"]
    data = np.frombuffer(b"".join(words), np.uint8).copy()
    offsets = np.concatenate([[0], np.cumsum([len(w) for w in words])]).astype(np.int64)
    valid = np.ones(len(words), np.uint8)
    enc = native._dict_encode_buffers(native.load(), data, offsets, valid, len(words))
    decoded = [w.decode("utf-8", "replace") for w in words]
    codes, vocab = _np_unique_codes(np.array(decoded, dtype=object))
    assert list(enc.vocab) == vocab == ["", "a", "b", "é", "�"]
    np.testing.assert_array_equal(enc.codes, codes)
    jenc = jnative._dict_encode_buffers(jnative.get_native(), data, offsets, valid, len(words))
    assert list(jenc.vocab).count("�") == 2  # the JAX vocabulary holds a duplicate
    assert list(jenc.to_object_array()) == list(enc.to_object_array()) == decoded


# ---------------------------------------------------------------------------
# Avro encode


def encode_frame(n: int, seed: int) -> pd.DataFrame:
    from examples._data import synthesize

    df = synthesize(n, seed=seed).drop(columns=["empty"])
    g = np.random.default_rng(seed)
    df["flag"] = g.random(n) < 0.5
    df["count"] = g.integers(-2**40, 2**40, n)
    df["wide"] = WIDE + g.integers(0, 5, n)
    df["greek"] = pd.Series(g.choice(["α", "β", "", "中"], n), dtype=object)
    df.loc[g.random(n) < 0.1, "greek"] = None
    return df


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_encoded_blocks_equal_jax_bytes(codec):
    from anovos_tpu.shared.native import native_avro_encode as jencode
    from anovos_tpu_torch.shared.native import native_avro_encode

    df = encode_frame(2500, seed=21)
    sync = bytes(range(16))
    got = native_avro_encode(df, sync, codec, 777)
    exp = jencode(df, sync, codec, 777)
    assert exp is not None and got == exp


@pytest.mark.parametrize("codec", ["null", "deflate", "snappy"])
def test_written_files_read_back_by_both_packages(tmp_path, codec):
    from anovos_tpu.data_ingest import avro_io as javro
    from anovos_tpu_torch.data_ingest import avro_io

    df = encode_frame(3000, seed=22)
    path = str(tmp_path / "f.avro")
    avro_io.write_avro(df, path, codec=codec, block_rows=1000)
    got, ref, jax = avro_io.read_avro(path), avro_io.read_avro_records(path), javro.read_avro(path)
    for c in df.columns:
        exp = df[c].to_numpy(dtype=object)
        if df[c].dtype.kind in "iub":
            np.testing.assert_array_equal(got[c], df[c].to_numpy(), err_msg=c)
            np.testing.assert_array_equal(ref[c], df[c].to_numpy(), err_msg=c)
            if c != "wide":  # the JAX decoder's float64 loses wide longs (pinned above)
                np.testing.assert_array_equal(jax[c], df[c].to_numpy(), err_msg=c)
        elif df[c].dtype.kind == "f":
            for r in (got, ref, jax):
                np.testing.assert_array_equal(r[c], df[c].to_numpy(), err_msg=c)
        else:
            want = [None if pd.isna(v) else v for v in exp]
            assert _objects(got[c]) == list(ref[c]) == _objects(jax[c]) == want, c


def test_snappy_blocks_carry_the_crc(tmp_path):
    """Each snappy block is raw snappy that pyarrow decompresses, followed
    by the big-endian CRC32 of the uncompressed block."""
    from anovos_tpu_torch.shared.native import native_avro_encode

    df = encode_frame(1200, seed=23)
    sync = b"S" * 16
    raw = native_avro_encode(df, sync, "null", 500)
    comp = native_avro_encode(df, sync, "snappy", 500)
    blocks_raw, blocks_comp = _blocks(raw, sync), _blocks(comp, sync)
    assert [b[0] for b in blocks_raw] == [b[0] for b in blocks_comp] == [500, 500, 200]
    for (_, plain), (_, body) in zip(blocks_raw, blocks_comp):
        assert int.from_bytes(body[-4:], "big") == zlib.crc32(plain)
        assert pa.Codec("snappy").decompress(body[:-4], len(plain), asbytes=True) == plain
        assert len(body) < len(plain)


def _blocks(body: bytes, sync: bytes):
    from anovos_tpu_torch.data_ingest.avro_io import _read_long

    buf, out = io.BytesIO(body), []
    while buf.tell() < len(body):
        nrec, blen = _read_long(buf), _read_long(buf)
        out.append((nrec, buf.read(blen)))
        assert buf.read(16) == sync
    return out


def test_unencodable_frames_go_to_the_python_writer(tmp_path, monkeypatch):
    """A datetime column is not the codec's: the whole frame goes to the
    record loop, which writes its str()."""
    from anovos_tpu_torch.data_ingest import avro_io
    from anovos_tpu_torch.shared import native

    df = pd.DataFrame({"t": pd.to_datetime(["2020-01-01", "2021-06-30"]), "x": [1.5, 2.5]})
    monkeypatch.setattr(native, "native_avro_encode", _refuse)
    avro_io.write_avro(df, str(tmp_path / "t.avro"))
    got = avro_io.read_avro(str(tmp_path / "t.avro"))
    assert list(got["t"].to_object_array()) == ["2020-01-01 00:00:00", "2021-06-30 00:00:00"]


def _refuse(*a, **k):
    raise AssertionError("the codec was called")


# ---------------------------------------------------------------------------
# components


def scipy_components(ei, ej, minc, thresh, n):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    k = minc >= thresh
    g = coo_matrix((np.ones(int(k.sum()), np.int8), (ei[k], ej[k])), shape=(n, n))
    return connected_components(g, directed=True, connection="weak")


@pytest.mark.parametrize("thresh", [np.iinfo(np.int64).min, 3, 6, 100])
def test_edge_components_equal_scipy_and_jax(thresh):
    from anovos_tpu.shared.native import native_edge_components_minc as jcomp
    from anovos_tpu_torch.shared.native import native_edge_components_minc

    g = np.random.default_rng(31)
    n, e = 5000, 6000
    ei, ej = g.integers(0, n, e), g.integers(0, n, e)
    minc = g.integers(0, 10, e)
    ncomp, labels = native_edge_components_minc(ei, ej, minc, thresh, n)
    sn, slabels = scipy_components(ei, ej, minc, thresh, n)
    jn, jlabels = jcomp(ei, ej, minc, thresh, n)
    assert ncomp == sn == jn
    np.testing.assert_array_equal(labels, slabels)
    np.testing.assert_array_equal(labels, jlabels)


def test_dbscan_grid_labels_equal_the_scipy_route(monkeypatch):
    """``dbscan_host_grid_multi`` through the union-find gives the labels
    of the same grid with scipy's components in its place."""
    from anovos_tpu_torch.ops import cluster

    g = np.random.default_rng(32)
    pts = np.concatenate([g.normal(c, 0.3, (300, 2)) for c in ((0, 0), (3, 3), (0, 4))]
                         + [g.uniform(-2, 6, (60, 2))]).astype(np.float32)
    D2 = ((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1)
    eps, ms = [0.2, 0.3, 0.45], [5, 15, 40]
    got = cluster.dbscan_host_grid_multi(D2, eps, ms)
    monkeypatch.setattr(cluster, "native_edge_components_minc",
                        lambda ei, ej, minc, t, n: scipy_components(ei, ej, minc, t, n))
    exp = cluster.dbscan_host_grid_multi(D2, eps, ms)
    np.testing.assert_array_equal(got, exp)
    assert (got >= 1).any() and (got == -1).any()


# ---------------------------------------------------------------------------
# build, load and the codec's choice of inputs


def test_failed_build_and_load_raise(tmp_path):
    from anovos_tpu_torch.shared import native

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(native.CodecError, match="codec build"):
        native.load(bad, tmp_path / "build")
    src = tmp_path / "src.cpp"
    shutil.copy(native.SOURCE, src)
    lib = native.library_path(src, tmp_path / "build")
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"not a shared library")
    with pytest.raises(native.CodecError, match="codec load"):
        native.load(src, tmp_path / "build")


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """The library's directory is named by a digest of the source and the
    flags: an edited source or other flags build a new library."""
    from anovos_tpu_torch.shared import native

    src, root = tmp_path / "src.cpp", tmp_path / "build"
    shutil.copy(native.SOURCE, src)
    first = native.load(src, root)
    p1 = native.library_path(src, root)
    assert p1.exists() and p1 in native.BUILD_LOG
    assert native.load(src, root) is first  # loaded once a process
    with open(src, "a") as f:
        f.write("// edited\n")
    p2 = native.library_path(src, root)
    assert p2 != p1 and not p2.exists()
    native.load(src, root)
    assert p2.exists() and p2 in native.BUILD_LOG
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DANOVOS_TEST_FLAG"])
    assert native.library_path(src, root) not in (p1, p2)


def test_unsupported_schemas_go_to_the_python_reader(tmp_path, monkeypatch):
    """A bytes field, a three-branch union or another block codec is not
    the codec's (the JAX package's rules): the record loop decodes it.  A
    corrupt block of an accepted file raises."""
    from anovos_tpu_torch.data_ingest import avro_io
    from anovos_tpu_torch.shared import native

    cols = {"a": ["x", "y", None], "b": [b"\x00", b"z", b""], "c": [1, None, 3]}
    cases = {
        "bytes": [{"name": "a", "type": ["string", "null"]}, {"name": "b", "type": "bytes"}],
        "union3": [{"name": "a", "type": ["string", "null", "int"]}],
        "union_no_null": [{"name": "c", "type": ["int", "long"]}],
    }
    assert avro_io.codec_fields([{"name": "a", "type": "string"}], "bzip2") is None
    for name, fields in cases.items():
        assert avro_io.codec_fields(fields, "null") is None, name
    with monkeypatch.context() as mp:
        mp.setattr(native, "native_avro_decode", _refuse)
        write_container(str(tmp_path / "b.avro"), cases["bytes"], cols, "deflate")
        got = avro_io.read_avro(str(tmp_path / "b.avro"))
    assert list(got["a"]) == ["x", "y", None] and list(got["b"]) == [b"\x00", b"z", b""]
    fields = [{"name": "a", "type": ["string", "null"]}]
    path = str(tmp_path / "bad.avro")
    write_container(path, fields, {"a": ["x" * 50] * 200}, "deflate", block_rows=200)
    raw = bytearray(open(path, "rb").read())
    raw[-40:-20] = b"\xff" * 20  # inside the deflate stream of the only block
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(native.CodecError, match="avro_decode"):
        avro_io.read_avro(path)
