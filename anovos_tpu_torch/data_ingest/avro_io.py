"""Minimal Avro object-container codec, read and write (counterpart of
``anovos_tpu/data_ingest/avro_io.py``).

The Avro binary format is varint/zigzag numbers and length-prefixed bytes.
Only the schemas Spark writes for flat DataFrames are supported: a top-level
record of primitive fields, each optionally nullable through a union with
"null".  ``read_avro`` and ``write_avro`` go through the port's C++ codec
(``shared/native.py``) wherever the header or the frame's dtypes allow, by
the JAX package's rules: field types boolean, int, long, float, double and
string, each alone or in a two-branch union with null, and the block codecs
null, deflate and snappy.  Everything else goes to the pure-Python record
loops, ``read_avro_records`` and ``write_avro_records``, whose block
compression goes to zlib (deflate) or pyarrow's bundled snappy.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from anovos_tpu_torch.shared import native

_MAGIC = b"Obj\x01"


def _read_long(buf: io.BufferedIOBase) -> int:
    n = 0
    shift = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated avro varint")
        byte = b[0]
        n |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (n >> 1) ^ -(n & 1)


def _write_long(out: io.BufferedIOBase, v: int) -> None:
    v = (v << 1) ^ (v >> 63)  # zigzag
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            break


def _read_bytes(buf: io.BufferedIOBase) -> bytes:
    return buf.read(_read_long(buf))


def _decompress(block: bytes, codec: str) -> bytes:
    if codec == "null":
        return block
    if codec == "deflate":
        return zlib.decompress(block, -15)
    if codec == "snappy":
        import pyarrow as pa

        comp = block[:-4]  # trailing 4-byte CRC32 of the uncompressed data
        size = 0
        shift = 0
        for byte in comp:  # snappy raw format: uncompressed length varint prefix
            size |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        out = pa.Codec("snappy").decompress(comp, size)
        return out.to_pybytes() if hasattr(out, "to_pybytes") else bytes(out)
    raise ValueError(f"unsupported avro codec: {codec}")


def _field_reader(ftype) -> Tuple[str, List]:
    """Normalize a field type to (base_type, union_branches)."""
    if isinstance(ftype, list):
        return "union", ftype
    if isinstance(ftype, dict):
        if ftype.get("logicalType"):
            return ftype["type"], []
        return ftype["type"], []
    return ftype, []


def _decode_value(buf, ftype):
    base, branches = _field_reader(ftype)
    if base == "union":
        idx = _read_long(buf)
        return _decode_value(buf, branches[idx])
    if base == "null":
        return None
    if base == "string":
        return _read_bytes(buf).decode("utf-8")
    if base == "bytes":
        return _read_bytes(buf)
    if base in ("int", "long"):
        return _read_long(buf)
    if base == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if base == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if base == "boolean":
        return buf.read(1)[0] == 1
    raise ValueError(f"unsupported avro type: {ftype}")


def _read_header(raw: bytes, path: str):
    """(fields, codec, sync, offset of the first block) of a container."""
    buf = io.BytesIO(raw)
    if buf.read(4) != _MAGIC:
        raise ValueError(f"not an avro container: {path}")
    meta: Dict[str, bytes] = {}
    while True:
        cnt = _read_long(buf)
        if cnt == 0:
            break
        if cnt < 0:  # a negative count is followed by the block's size
            _read_long(buf)
        for _ in range(abs(cnt)):
            k = _read_bytes(buf).decode()
            meta[k] = _read_bytes(buf)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    sync = buf.read(16)
    return schema["fields"], codec, sync, buf.tell()


def codec_fields(fields, codec: str) -> Optional[List[Tuple[str, str, int]]]:
    """The codec's field spec for a header, (name, base type, null branch
    or −1) a field, or None where the codec does not take the schema or the
    block codec (the JAX package's ``_try_native_decode`` rules)."""
    if codec not in native.AVRO_CODECS:
        return None
    spec = []
    for f in fields:
        base, branches = _field_reader(f["type"])
        null_idx = -1
        if base == "union":
            bases = [_field_reader(b)[0] for b in branches]
            if len(bases) != 2 or "null" not in bases:
                return None
            null_idx = bases.index("null")
            base = bases[1 - null_idx]
        if base not in native.AVRO_TYPES:
            return None
        spec.append((f["name"], base, null_idx))
    return spec


def read_avro(path: str) -> Dict[str, np.ndarray]:
    """Read one .avro container file → dict of host column arrays: int and
    long fields exact int64 without nulls, else float64 with NaN for null;
    float and double float64; booleans bool (null False); strings
    dictionary-encoded (:class:`~anovos_tpu_torch.shared.native.NativeEncodedStrings`)
    through the codec, or object arrays where the Python reader decodes."""
    with open(path, "rb") as f:
        raw = f.read()
    fields, codec, sync, offset = _read_header(raw, path)
    spec = codec_fields(fields, codec)
    if spec is not None:
        return native.native_avro_decode(raw, offset, sync, codec, spec)
    return _decode_records(raw, fields, codec, sync, offset)


def read_avro_records(path: str) -> Dict[str, np.ndarray]:
    """``read_avro`` through the pure-Python record loop, whatever the
    schema (strings as object arrays)."""
    with open(path, "rb") as f:
        raw = f.read()
    return _decode_records(raw, *_read_header(raw, path))


def _decode_records(raw: bytes, fields, codec: str, sync: bytes, offset: int) -> Dict[str, np.ndarray]:
    buf = io.BytesIO(raw)
    buf.seek(offset)
    cols: Dict[str, list] = {f["name"]: [] for f in fields}
    while buf.tell() < len(raw):
        try:
            nrec = _read_long(buf)
        except EOFError:
            break
        blen = _read_long(buf)
        block = io.BytesIO(_decompress(buf.read(blen), codec))
        if buf.read(16) != sync:
            raise ValueError("avro sync marker mismatch")
        for _ in range(nrec):
            for f in fields:
                cols[f["name"]].append(_decode_value(block, f["type"]))
    out: Dict[str, np.ndarray] = {}
    for f in fields:
        name = f["name"]
        base, branches = _field_reader(f["type"])
        types = {b for b in ([base] if base != "union" else [
            (_field_reader(x)[0]) for x in branches])} - {"null"}
        vals = cols[name]
        if types <= {"int", "long"} and types and None not in vals:
            out[name] = np.array(vals, dtype=np.int64)
        elif types <= {"int", "long", "float", "double"} and types:
            out[name] = np.array([np.nan if v is None else v for v in vals], dtype=np.float64)
        elif types == {"boolean"}:
            out[name] = np.array([False if v is None else v for v in vals], dtype=bool)
        else:
            out[name] = np.array(vals, dtype=object)
    return out


def _avro_schema_for(df) -> dict:
    import pandas.api.types as pdt

    fields = []
    for name in df.columns:
        dt = df[name].dtype
        if pdt.is_bool_dtype(dt):
            t = "boolean"
        elif pdt.is_integer_dtype(dt):
            t = "long"
        elif pdt.is_float_dtype(dt):
            t = "double"
        else:
            t = "string"
        fields.append({"name": str(name), "type": [t, "null"]})
    return {"type": "record", "name": "topLevelRecord", "fields": fields}


def _encode_value(out, v, ftype) -> None:
    t = ftype[0] if isinstance(ftype, list) else ftype
    isnull = v is None or (isinstance(v, float) and np.isnan(v))
    if isinstance(ftype, list):
        _write_long(out, 1 if isnull else 0)
        if isnull:
            return
        ftype = ftype[0]
        t = ftype
    if t == "string":
        b = str(v).encode("utf-8")
        _write_long(out, len(b))
        out.write(b)
    elif t == "long" or t == "int":
        _write_long(out, int(v))
    elif t == "double":
        out.write(struct.pack("<d", float(v)))
    elif t == "float":
        out.write(struct.pack("<f", float(v)))
    elif t == "boolean":
        out.write(b"\x01" if v else b"\x00")
    else:
        raise ValueError(f"unsupported avro write type {ftype}")


def _header(schema: dict, codec: str, sync: bytes) -> io.BytesIO:
    out = io.BytesIO()
    out.write(_MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec.encode()}
    _write_long(out, len(meta))
    for k, v in meta.items():
        kb = k.encode()
        _write_long(out, len(kb))
        out.write(kb)
        _write_long(out, len(v))
        out.write(v)
    _write_long(out, 0)
    out.write(sync)
    return out


def write_avro(df, path: str, codec: str = "deflate", block_rows: int = 16384) -> None:
    """Write a pandas DataFrame as one Avro container file: through the
    codec where every column is bool, integer, float or string-like
    (``native.avro_field_type``) and ``codec`` is null, deflate or snappy,
    else through :func:`write_avro_records`."""
    if codec not in native.AVRO_CODECS or any(
            native.avro_field_type(df[c].dtype) is None for c in df.columns):
        write_avro_records(df, path, codec, block_rows)
        return
    sync = os.urandom(16)
    out = _header(_avro_schema_for(df), codec, sync)
    out.write(native.native_avro_encode(df, sync, codec, block_rows))
    with open(path, "wb") as f:
        f.write(out.getvalue())


def write_avro_records(df, path: str, codec: str = "deflate", block_rows: int = 16384) -> None:
    """``write_avro`` through the pure-Python record loop (codecs null and
    deflate), whatever the dtypes."""
    schema = _avro_schema_for(df)
    sync = os.urandom(16)
    out = _header(schema, codec, sync)
    cols = [df[c].tolist() for c in df.columns]
    ftypes = [f["type"] for f in schema["fields"]]
    n = len(df)
    for start in range(0, max(n, 1), block_rows):
        stop = min(start + block_rows, n)
        if stop <= start:
            break
        block = io.BytesIO()
        for i in range(start, stop):
            for c, ft in zip(cols, ftypes):
                _encode_value(block, c[i], ft)
        data = block.getvalue()
        if codec == "deflate":
            comp = zlib.compressobj(wbits=-15)
            data = comp.compress(data) + comp.flush()
        elif codec != "null":
            raise ValueError(f"unsupported avro write codec {codec}")
        _write_long(out, stop - start)
        _write_long(out, len(data))
        out.write(data)
        out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())
