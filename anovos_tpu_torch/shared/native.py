"""The port's host codec (counterpart of ``anovos_tpu/shared/native.py``):
Avro decode and encode, dictionary encoding of string columns, and the
union-find components of DBSCAN's grid, in C++ (``csrc/anovos_native.cpp``)
called through ``ctypes``.

The library is built from that source with ``g++`` at its first use, into
``build/anovos_tpu_torch_kernels/<digest>/`` at the root of the checkout;
the digest covers the source, the compiler flags and the libraries, so an
edited source is rebuilt and a stale library is never loaded.  Nothing is
built or loaded when this module is imported.

There is no fallback: a failed build, a failed load or a negative return on
an input the codec accepted raises :class:`CodecError`, which names the
step.  Which inputs go to the codec is decided by the callers before the
call (``data_ingest/avro_io.py`` from the Avro header and the frame's
dtypes, ``shared/table.py`` from the array's type).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa

SOURCE = Path(__file__).resolve().parent / "csrc" / "anovos_native.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "anovos_tpu_torch_kernels"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
LINK = ["-lz"]
LIB_NAME = "libanovos_native.so"

# the codec's field types and block codecs (anovos_native.cpp FieldType)
AVRO_TYPES = {"boolean": 1, "int": 2, "long": 2, "float": 3, "double": 4, "string": 5}
AVRO_CODECS = {"null": 0, "deflate": 1, "snappy": 2}
_FT_BOOL, _FT_INT, _FT_DOUBLE, _FT_STRING = 1, 2, 4, 5

_LOCK = threading.Lock()
_LIBS: Dict[Path, ctypes.CDLL] = {}
# the compiler's output and seconds for each library built in this process
BUILD_LOG: Dict[Path, dict] = {}


class CodecError(RuntimeError):
    """The codec failed to build, to load, or on an input it accepted."""


class NativeEncodedStrings:
    """A string column dictionary-encoded by the codec: int32 codes (−1
    null) into a sorted vocabulary.  ``host_to_column`` takes it as it is,
    so the strings never become Python objects a row."""

    def __init__(self, codes: np.ndarray, vocab: np.ndarray):
        self.codes = codes
        self.vocab = vocab

    def __len__(self) -> int:
        return len(self.codes)

    def to_object_array(self) -> np.ndarray:
        out = np.empty(len(self.codes), dtype=object)
        valid = self.codes >= 0
        out[valid] = self.vocab[self.codes[valid]]
        out[~valid] = None
        return out


# ---------------------------------------------------------------------------
# build and load


def library_path(source: Path = SOURCE, root: Path = BUILD_ROOT) -> Path:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS, *LINK]).encode())
    h.update(Path(source).read_bytes())
    return Path(root) / h.hexdigest()[:16] / LIB_NAME


def _build(source: Path, lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(source), "-o", str(tmp), *LINK],
                              capture_output=True, text=True)
    except OSError as e:
        raise CodecError(f"codec build: cannot run {CXX}: {e}") from e
    if proc.returncode != 0:
        raise CodecError(f"codec build: {CXX} failed on {source} (exit {proc.returncode}):\n"
                         f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    BUILD_LOG[lib] = {"seconds": time.perf_counter() - t0, "output": proc.stdout + proc.stderr}


def _register(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    dpp = ctypes.POINTER(ctypes.POINTER(ctypes.c_double))
    u8pp = ctypes.POINTER(u8p)
    i64pp = ctypes.POINTER(i64p)
    # full argtypes: ctypes' default c_int would cut the int64_t lengths
    lib.avro_decode.restype = ctypes.c_int64
    lib.avro_decode.argtypes = [
        u8p, ctypes.c_int64, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, u8p, ctypes.c_int32, dpp, i64pp, u8pp, i64pp, u8pp, i64p,
    ]
    lib.dict_encode.restype = ctypes.c_int64
    lib.dict_encode.argtypes = [u8p, i64p, u8p, ctypes.c_int64, i32p, i64p, u8p, ctypes.c_int64, i64p]
    lib.avro_encode.restype = ctypes.c_int64
    lib.avro_encode.argtypes = [
        i32p, ctypes.c_int32, ctypes.c_int64, dpp, i64pp, u8pp, i64pp, u8pp,
        ctypes.c_int32, u8p, ctypes.c_int64, u8p, ctypes.c_int64,
    ]
    lib.edge_components_minc.restype = ctypes.c_int64
    lib.edge_components_minc.argtypes = [i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, i64p]


def load(source: Path = SOURCE, root: Path = BUILD_ROOT) -> ctypes.CDLL:
    """The codec library, built first if the one for this source and these
    flags is missing."""
    lib_path = library_path(source, root)
    with _LOCK:
        if lib_path not in _LIBS:
            if not lib_path.exists():
                _build(Path(source), lib_path)
            try:
                lib = ctypes.CDLL(str(lib_path))
                _register(lib)
            except (OSError, AttributeError) as e:
                raise CodecError(f"codec load: {lib_path}: {e}") from e
            _LIBS[lib_path] = lib
        return _LIBS[lib_path]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _ptr_array(arrays, ctype):
    """Array of pointers for a list of numpy arrays (None → NULL)."""
    ptrs = (ctypes.POINTER(ctype) * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = _ptr(a, ctype) if a is not None else None
    return ptrs


def _checked(ret: int, step: str) -> int:
    if ret < 0:
        raise CodecError(f"codec {step} returned {ret}")
    return ret


# ---------------------------------------------------------------------------
# Avro decode


def native_avro_decode(raw: bytes, header_offset: int, sync: bytes, codec: str,
                       fields: List[Tuple[str, str, int]]) -> dict:
    """Decode the blocks of an Avro container.

    ``fields``: (name, base_type, null_branch_index) with base_type a key of
    :data:`AVRO_TYPES` and null_branch_index the union branch that holds
    "null" (−1 if not nullable); ``codec`` a key of :data:`AVRO_CODECS`.
    Returns name → column: int/long fields exact int64 where every value is
    valid, else float64 with NaN; float/double float64 with NaN; boolean a
    bool array (nulls False, as the Python reader); string a
    :class:`NativeEncodedStrings`."""
    lib = load()
    ftypes = np.asarray([AVRO_TYPES[base] for _, base, _ in fields], np.int32)
    nullidx = np.asarray([nb for _, _, nb in fields], np.int32)
    nfields = len(fields)
    buf = np.frombuffer(raw, dtype=np.uint8)
    sync_a = np.frombuffer(sync, dtype=np.uint8)

    def run(fill, doubles, longs, valid, str_off, str_bytes, used):
        return lib.avro_decode(
            _ptr(buf, ctypes.c_uint8), len(raw), _ptr(ftypes, ctypes.c_int32),
            _ptr(nullidx, ctypes.c_int32), nfields, AVRO_CODECS[codec], header_offset,
            _ptr(sync_a, ctypes.c_uint8), fill,
            _ptr_array(doubles, ctypes.c_double), _ptr_array(longs, ctypes.c_int64),
            _ptr_array(valid, ctypes.c_uint8), _ptr_array(str_off, ctypes.c_int64),
            _ptr_array(str_bytes, ctypes.c_uint8), _ptr(used, ctypes.c_int64))

    none = [None] * nfields
    used = np.zeros(nfields, np.int64)
    nrec = _checked(run(0, none, none, none, none, none, used), "avro_decode (count)")
    doubles = [np.zeros(nrec, np.float64) if t not in (_FT_INT, _FT_STRING) else None for t in ftypes]
    longs = [np.zeros(nrec, np.int64) if t == _FT_INT else None for t in ftypes]
    valid = [np.zeros(nrec, np.uint8) for _ in ftypes]
    str_off = [np.zeros(nrec + 1, np.int64) if t == _FT_STRING else None for t in ftypes]
    str_bytes = [np.zeros(max(int(u), 1), np.uint8) if t == _FT_STRING else None
                 for t, u in zip(ftypes, used)]
    nrec2 = _checked(run(1, doubles, longs, valid, str_off, str_bytes, np.zeros(nfields, np.int64)),
                     "avro_decode (fill)")
    if nrec2 != nrec:
        raise CodecError(f"codec avro_decode: {nrec} records counted, {nrec2} filled")
    out = {}
    for i, (name, base, _) in enumerate(fields):
        v = valid[i].astype(bool)
        if ftypes[i] == _FT_STRING:
            out[name] = _dict_encode_buffers(lib, str_bytes[i], str_off[i], valid[i], nrec)
        elif base == "boolean":
            out[name] = (doubles[i] != 0) & v
        elif ftypes[i] == _FT_INT and v.all():
            out[name] = longs[i]
        else:
            arr = longs[i].astype(np.float64) if ftypes[i] == _FT_INT else doubles[i]
            arr[~v] = np.nan
            out[name] = arr
    return out


# ---------------------------------------------------------------------------
# dictionary encoding


def _dict_encode_buffers(lib, arena: np.ndarray, offsets: np.ndarray, valid: np.ndarray,
                         n: int) -> NativeEncodedStrings:
    """``dict_encode`` over (bytes, offsets, validity): codes into the
    vocabulary sorted as ``np.unique`` sorts the decoded strings."""
    codes = np.zeros(max(n, 1), np.int32)
    vocab_off = np.zeros(n + 2, np.int64)
    vocab_bytes = np.zeros(max(len(arena), 1), np.uint8)
    vb_used = np.zeros(1, np.int64)
    vsize = _checked(lib.dict_encode(
        _ptr(arena, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64), _ptr(valid, ctypes.c_uint8), n,
        _ptr(codes, ctypes.c_int32), _ptr(vocab_off, ctypes.c_int64), _ptr(vocab_bytes, ctypes.c_uint8),
        len(vocab_bytes), _ptr(vb_used, ctypes.c_int64)), "dict_encode")
    codes = codes[:n]
    strings = pa.LargeStringArray.from_buffers(
        vsize, pa.py_buffer(vocab_off[:vsize + 1]), pa.py_buffer(vocab_bytes[:max(int(vb_used[0]), 1)]))
    try:
        strings.validate(full=True)
    except pa.ArrowInvalid:
        # bytes that are not UTF-8: decoded with replacement characters, two
        # entries may decode alike and byte order is no longer string order
        vb = vocab_bytes.tobytes()
        decoded = np.array([vb[vocab_off[j]:vocab_off[j + 1]].decode("utf-8", "replace")
                            for j in range(vsize)], dtype=object)
        vocab, remap = np.unique(decoded, return_inverse=True)
        codes = np.where(codes >= 0, remap.astype(np.int32)[np.maximum(codes, 0)], -1).astype(np.int32)
        return NativeEncodedStrings(codes, vocab.astype(object))
    # byte order of valid UTF-8 is code-point order, the order np.unique gives
    return NativeEncodedStrings(codes, strings.to_numpy(zero_copy_only=False).astype(object))


def is_string_dtype(dtype) -> bool:
    """A pandas string dtype: ``str``/``string`` or Arrow ``string``."""
    return isinstance(dtype, pd.StringDtype) or (
        isinstance(dtype, pd.ArrowDtype) and (pa.types.is_string(dtype.pyarrow_dtype)
                                              or pa.types.is_large_string(dtype.pyarrow_dtype)))


def string_buffers(vals) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(UTF-8 bytes, int64 offsets, uint8 validity) of a column whose every
    value is a ``str`` or null: an Arrow string array, a pandas string
    array, a numpy unicode array, or an object array of ``str`` and nulls
    (None, NaN).  None for any other column."""
    if isinstance(vals, (pa.Array, pa.ChunkedArray)):
        arr = vals
    elif isinstance(vals, pd.api.extensions.ExtensionArray):
        if not is_string_dtype(vals.dtype):
            return None
        arr = pa.array(vals)
    else:
        vals = np.asarray(vals)
        if vals.dtype.kind != "U" and not (vals.dtype == object
                                           and pd.api.types.infer_dtype(vals, skipna=True) == "string"):
            return None
        try:
            arr = pa.array(vals, type=pa.large_string(), from_pandas=True)
        except UnicodeEncodeError:  # a lone surrogate: not UTF-8
            return None
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if not (pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type)):
        return None
    arr = arr.cast(pa.large_string())
    n = len(arr)
    _, off_buf, data_buf = arr.buffers()
    offsets = np.frombuffer(off_buf, np.int64, n + 1, arr.offset * 8) if n else np.zeros(1, np.int64)
    data = (np.frombuffer(data_buf, np.uint8) if data_buf is not None and data_buf.size
            else np.zeros(1, np.uint8))
    valid = arr.is_valid().to_numpy(zero_copy_only=False).astype(np.uint8)
    return data, np.ascontiguousarray(offsets), valid


def dict_encode_strings(vals) -> Optional[NativeEncodedStrings]:
    """The codec's dictionary encoding of a string column (see
    :func:`string_buffers`); None when the column is not one."""
    bufs = string_buffers(vals)
    if bufs is None:
        return None
    data, offsets, valid = bufs
    return _dict_encode_buffers(load(), data, offsets, valid, len(valid))


# ---------------------------------------------------------------------------
# Avro encode


def _encode_strings(s: pd.Series):
    bufs = string_buffers(s.array)
    if bufs is None:
        # other objects: str() of each, None and NaN null (the Python writer's rule)
        vals = s.to_numpy(dtype=object)
        bufs = string_buffers(np.array(
            [None if v is None or (isinstance(v, float) and np.isnan(v)) else str(v) for v in vals],
            dtype=object))
        if bufs is None:  # every value null
            n = len(vals)
            bufs = np.zeros(1, np.uint8), np.zeros(n + 1, np.int64), np.zeros(n, np.uint8)
    return bufs


def avro_field_type(dtype) -> Optional[str]:
    """The Avro type the writer gives a column of ``dtype`` (a [T, "null"]
    union), or None where the codec does not encode it (datetimes and other
    objects the Python writer turns into strings)."""
    import pandas.api.types as pdt

    if pdt.is_bool_dtype(dtype):
        return "boolean"
    if pdt.is_integer_dtype(dtype):
        return "long"
    if pdt.is_float_dtype(dtype):
        return "double"
    if dtype == object or isinstance(dtype, pd.CategoricalDtype) or is_string_dtype(dtype):
        return "string"
    return None


def native_avro_encode(df: pd.DataFrame, sync: bytes, codec: str, block_rows: int) -> bytes:
    """The record blocks of ``df`` (each followed by ``sync``), every field a
    [T, "null"] union of :func:`avro_field_type`; ``codec`` a key of
    :data:`AVRO_CODECS`."""
    lib = load()
    n = len(df)
    ftypes, doubles, longs, valids, str_offs, str_bytes = [], [], [], [], [], []
    bound = 0
    for name in df.columns:
        s = df[name]
        t = avro_field_type(s.dtype)
        d = l = off = arena = None
        if t == "boolean":
            ft, d, v, per = _FT_BOOL, s.to_numpy(np.float64, na_value=0.0), ~s.isna().to_numpy(), 2
        elif t == "long":
            ft, l, v, per = _FT_INT, s.to_numpy(np.int64, na_value=0), ~s.isna().to_numpy(), 11
        elif t == "double":
            vals = s.to_numpy(np.float64, na_value=np.nan)
            ft, d, v, per = _FT_DOUBLE, np.nan_to_num(vals, nan=0.0), ~np.isnan(vals), 9
        elif t == "string":
            arena, off, v = _encode_strings(s)
            ft, per = _FT_STRING, 6
            bound += int(off[-1])
        else:
            raise ValueError(f"codec avro_encode: column {name!r} of dtype {s.dtype} is not encodable")
        ftypes.append(ft)
        doubles.append(None if d is None else np.ascontiguousarray(d, np.float64))
        longs.append(None if l is None else np.ascontiguousarray(l, np.int64))
        valids.append(np.ascontiguousarray(v, np.uint8))
        str_offs.append(off)
        str_bytes.append(arena)
        bound += n * per
    nblocks = max(1, -(-n // block_rows))
    # compressed blocks may outgrow their records: snappy by 1/6, deflate less
    bound += bound // 6 + nblocks * 64 + 64
    out = np.zeros(bound, np.uint8)
    ftypes_a = np.asarray(ftypes, np.int32)
    sync_a = np.frombuffer(sync, dtype=np.uint8)
    used = _checked(lib.avro_encode(
        _ptr(ftypes_a, ctypes.c_int32), len(ftypes), n,
        _ptr_array(doubles, ctypes.c_double), _ptr_array(longs, ctypes.c_int64),
        _ptr_array(valids, ctypes.c_uint8), _ptr_array(str_offs, ctypes.c_int64),
        _ptr_array(str_bytes, ctypes.c_uint8), AVRO_CODECS[codec], _ptr(sync_a, ctypes.c_uint8),
        block_rows, _ptr(out, ctypes.c_uint8), len(out)), "avro_encode")
    return out[:used].tobytes()


# ---------------------------------------------------------------------------
# connected components


def native_edge_components_minc(ei: np.ndarray, ej: np.ndarray, minc: np.ndarray, thresh: int,
                                n_nodes: int) -> Tuple[int, np.ndarray]:
    """Union-find components over the edges with ``minc >= thresh`` (both
    endpoints core at this min_samples level): (the component count, int64
    labels over all ``n_nodes``, dense in the order of each component's
    smallest member, as scipy's ``connected_components`` numbers them)."""
    lib = load()
    ei = np.ascontiguousarray(ei, np.int64)
    ej = np.ascontiguousarray(ej, np.int64)
    minc = np.ascontiguousarray(minc, np.int64)
    if not len(ei) == len(ej) == len(minc):
        raise ValueError("edge_components_minc: ei, ej and minc differ in length")
    out = np.empty(n_nodes, np.int64)
    ncomp = _checked(lib.edge_components_minc(
        _ptr(ei, ctypes.c_int64), _ptr(ej, ctypes.c_int64), _ptr(minc, ctypes.c_int64), len(ei),
        int(thresh), n_nodes, _ptr(out, ctypes.c_int64)), "edge_components_minc")
    return int(ncomp), out
