// anovos_native — the port's host codec: columnar Avro decode and encode,
// dictionary encoding of string columns, and the connected components of
// DBSCAN's hyperparameter grid.  Loaded with ctypes by
// anovos_tpu_torch/shared/native.py, which builds it at first use.
//
//  - Avro object-container decode (deflate through zlib, raw snappy decoded
//    here) straight into columnar buffers: int and long fields as exact
//    int64, float, double and boolean fields as double;
//  - dictionary encoding of a string column given as (bytes, offsets,
//    validity): int32 codes (-1 null) into a vocabulary sorted by its bytes,
//    which for UTF-8 is code-point order, the order of np.unique on str;
//  - Avro block encode (null, deflate or snappy with its CRC32 suffix);
//  - union-find components over a thresholded edge list.
//
// Memory protocol for the decode: two-phase.  Phase 1 (count) walks the
// container and returns record/byte counts so Python can allocate numpy
// buffers; phase 2 (fill) fills them.  All buffers are caller-owned.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared anovos_native.cpp -o libanovos_native.so -lz

#include <algorithm>
#include <numeric>
#include <cstdint>
#include <cstring>
#include <utility>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <zlib.h>

extern "C" {

// field type codes (subset Spark writes for flat frames)
enum FieldType : int32_t {
  FT_NULL = 0,
  FT_BOOL = 1,
  FT_INT = 2,    // int | long  (zigzag varint), decoded as exact int64
  FT_FLOAT = 3,  // float32
  FT_DOUBLE = 4, // float64
  FT_STRING = 5, // length-prefixed utf8
};

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  int64_t read_long() {
    uint64_t n = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      n |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return static_cast<int64_t>(n >> 1) ^ -static_cast<int64_t>(n & 1);
      shift += 7;
    }
    ok = false;
    return 0;
  }

  bool skip(int64_t n) {
    if (p + n > end) { ok = false; return false; }
    p += n;
    return true;
  }
};

// raw snappy decompress (format: uncompressed-length varint, then literal /
// copy tagged elements)
static bool snappy_uncompress(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  size_t pos = 0;
  uint64_t ulen = 0;
  int shift = 0;
  while (pos < n) {
    uint8_t b = src[pos++];
    ulen |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  // sanity bound: snappy caps expansion; a corrupt length varint must not
  // drive a multi-GB allocation
  if (ulen > n * 64 + (1u << 20)) return false;
  out.clear();
  out.reserve(ulen);
  while (pos < n) {
    uint8_t tag = src[pos++];
    uint32_t type = tag & 3;
    if (type == 0) {  // literal
      uint32_t len = (tag >> 2) + 1;
      if (len > 60) {
        uint32_t extra = len - 60;
        if (pos + extra > n) return false;
        len = 0;
        for (uint32_t i = 0; i < extra; i++) len |= static_cast<uint32_t>(src[pos + i]) << (8 * i);
        len += 1;
        pos += extra;
      }
      if (pos + len > n) return false;
      out.insert(out.end(), src + pos, src + pos + len);
      pos += len;
    } else {
      uint32_t len, offset;
      if (type == 1) {
        if (pos >= n) return false;
        len = ((tag >> 2) & 7) + 4;
        offset = (static_cast<uint32_t>(tag >> 5) << 8) | src[pos++];
      } else if (type == 2) {
        if (pos + 2 > n) return false;
        len = (tag >> 2) + 1;
        offset = src[pos] | (static_cast<uint32_t>(src[pos + 1]) << 8);
        pos += 2;
      } else {
        if (pos + 4 > n) return false;
        len = (tag >> 2) + 1;
        offset = src[pos] | (static_cast<uint32_t>(src[pos + 1]) << 8) |
                 (static_cast<uint32_t>(src[pos + 2]) << 16) | (static_cast<uint32_t>(src[pos + 3]) << 24);
        pos += 4;
      }
      if (offset == 0 || offset > out.size()) return false;
      size_t start = out.size() - offset;
      for (uint32_t i = 0; i < len; i++) out.push_back(out[start + i]);  // may overlap
    }
  }
  return out.size() == ulen;
}

static bool inflate_raw(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  z_stream zs{};
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  out.clear();
  out.resize(n * 4 + 4096);
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  size_t written = 0;
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    if (written == out.size()) out.resize(out.size() * 2);
    zs.next_out = out.data() + written;
    zs.avail_out = static_cast<uInt>(out.size() - written);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) { inflateEnd(&zs); return false; }
    written = out.size() - zs.avail_out;
    if (ret == Z_OK && zs.avail_in == 0 && zs.avail_out > 0) break;
  }
  out.resize(written);
  inflateEnd(&zs);
  return true;
}

// codec: 0 = null, 1 = deflate, 2 = snappy (4-byte CRC suffix stripped by caller? no — handled here)
static bool decode_block_bytes(const uint8_t* src, size_t n, int codec, std::vector<uint8_t>& out) {
  if (codec == 0) { out.assign(src, src + n); return true; }
  if (codec == 1) return inflate_raw(src, n, out);
  if (codec == 2) return n >= 4 && snappy_uncompress(src, n - 4, out);
  return false;
}

// Walk all container blocks once.  Outputs per record, per field into
// caller buffers.  For each field i:
//   doubles[i] : double* (bool, float, double) or nullptr
//   longs[i]   : int64_t* (int, long) or nullptr
//   valid[i]   : uint8_t* (1 = non-null)
//   str_off[i] : int64_t* cumulative byte offsets (len nrec+1), strings only
// String bytes append into one shared arena per field (str_bytes[i], capacity
// str_cap): phase 1 (fill=0) only counts; phase 2 (fill=1) writes.
//
// Returns number of records decoded, or -1 on error.
static int64_t avro_decode_impl(
    const uint8_t* data, int64_t len,
    const int32_t* field_types, const int32_t* union_null_first, int32_t nfields,
    int32_t codec, int64_t header_offset, const uint8_t* sync,
    int32_t fill,
    double** doubles, int64_t** longs, uint8_t** valid, int64_t** str_off, uint8_t** str_bytes,
    int64_t* str_bytes_used /* per field, out */) {
  const uint8_t* p = data + header_offset;
  const uint8_t* end = data + len;
  std::vector<uint8_t> block;
  int64_t rec = 0;
  std::vector<int64_t> sbytes(nfields, 0);
  while (p < end) {
    Reader hdr{p, end};
    int64_t nrec = hdr.read_long();
    int64_t blen = hdr.read_long();
    // validate sizes BEFORE pointer arithmetic: a corrupt varint can be
    // negative or huge and `hdr.p + blen` would wrap past `end`
    if (!hdr.ok || nrec < 0 || blen < 0) break;
    if (blen > end - hdr.p || end - hdr.p - blen < 16) break;
    if (!decode_block_bytes(hdr.p, static_cast<size_t>(blen), codec, block)) return -1;
    if (memcmp(hdr.p + blen, sync, 16) != 0) return -2;
    p = hdr.p + blen + 16;
    Reader r{block.data(), block.data() + block.size()};
    for (int64_t k = 0; k < nrec; k++, rec++) {
      for (int32_t f = 0; f < nfields; f++) {
        int32_t ft = field_types[f];
        bool isnull = false;
        if (union_null_first[f] >= 0) {  // nullable union; value = branch index
          int64_t branch = r.read_long();
          isnull = (branch == union_null_first[f]);
        }
        if (fill) valid[f][rec] = isnull ? 0 : 1;
        if (isnull) {
          if (fill) {
            if (ft == FT_STRING) str_off[f][rec + 1] = sbytes[f];
            else if (ft == FT_INT) longs[f][rec] = 0;
            else doubles[f][rec] = 0.0;
          }
          continue;
        }
        switch (ft) {
          case FT_BOOL: {
            if (r.p >= r.end) return -3;
            double v = (*r.p++ == 1) ? 1.0 : 0.0;
            if (fill) doubles[f][rec] = v;
            break;
          }
          case FT_INT: {
            int64_t v = r.read_long();
            if (fill) longs[f][rec] = v;
            break;
          }
          case FT_FLOAT: {
            float v;
            if (r.p + 4 > r.end) return -3;
            memcpy(&v, r.p, 4); r.p += 4;
            if (fill) doubles[f][rec] = v;
            break;
          }
          case FT_DOUBLE: {
            double v;
            if (r.p + 8 > r.end) return -3;
            memcpy(&v, r.p, 8); r.p += 8;
            if (fill) doubles[f][rec] = v;
            break;
          }
          case FT_STRING: {
            int64_t slen = r.read_long();
            if (slen < 0 || r.p + slen > r.end) return -3;
            if (fill) {
              memcpy(str_bytes[f] + sbytes[f], r.p, static_cast<size_t>(slen));
              str_off[f][rec + 1] = sbytes[f] + slen;
            }
            sbytes[f] += slen;
            r.p += slen;
            break;
          }
          default:
            return -4;
        }
        if (!r.ok) return -3;
      }
    }
  }
  for (int32_t f = 0; f < nfields; f++) str_bytes_used[f] = sbytes[f];
  return rec;
}

int64_t avro_decode(
    const uint8_t* data, int64_t len,
    const int32_t* field_types, const int32_t* union_null_first, int32_t nfields,
    int32_t codec, int64_t header_offset, const uint8_t* sync,
    int32_t fill,
    double** doubles, int64_t** longs, uint8_t** valid, int64_t** str_off, uint8_t** str_bytes,
    int64_t* str_bytes_used) {
  // exceptions (bad_alloc from corrupt sizes) must not cross the C ABI
  try {
    return avro_decode_impl(data, len, field_types, union_null_first, nfields,
                            codec, header_offset, sync, fill, doubles, longs, valid,
                            str_off, str_bytes, str_bytes_used);
  } catch (...) {
    return -5;
  }
}

// Dictionary-encode one string column given as offsets+bytes: codes out,
// returns the vocabulary size, the vocabulary emitted as (vocab_off,
// vocab_bytes) sorted by its bytes and the codes numbered in that order.
// Returns -1 if the vocabulary outgrows vocab_cap, -2 on an exception.
static int64_t dict_encode_impl(
    const uint8_t* bytes, const int64_t* offsets, const uint8_t* valid, int64_t n,
    int32_t* codes, int64_t* vocab_off, uint8_t* vocab_bytes, int64_t vocab_cap,
    int64_t* vocab_bytes_used) {
  std::unordered_map<std::string_view, int32_t> lut;
  lut.reserve(static_cast<size_t>(n) / 4 + 8);
  int64_t vb = 0;
  int32_t next = 0;
  vocab_off[0] = 0;
  for (int64_t i = 0; i < n; i++) {
    if (!valid[i]) { codes[i] = -1; continue; }
    std::string_view sv(reinterpret_cast<const char*>(bytes + offsets[i]),
                        static_cast<size_t>(offsets[i + 1] - offsets[i]));
    auto it = lut.find(sv);
    if (it == lut.end()) {
      if (vb + static_cast<int64_t>(sv.size()) > vocab_cap) return -1;
      memcpy(vocab_bytes + vb, sv.data(), sv.size());
      vb += static_cast<int64_t>(sv.size());
      vocab_off[next + 1] = vb;
      // the key must view the arena copy (stable storage), not the input
      std::string_view stable(reinterpret_cast<const char*>(vocab_bytes + vocab_off[next]), sv.size());
      lut.emplace(stable, next);
      codes[i] = next;
      next++;
    } else {
      codes[i] = it->second;
    }
  }
  // first-touch ids -> ranks in byte order (char_traits<char> compares as
  // unsigned char, like memcmp)
  auto view = [&](int32_t j) {
    return std::string_view(reinterpret_cast<const char*>(vocab_bytes + vocab_off[j]),
                            static_cast<size_t>(vocab_off[j + 1] - vocab_off[j]));
  };
  std::vector<int32_t> order(next);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) { return view(a) < view(b); });
  std::vector<int32_t> rank(next);
  for (int32_t j = 0; j < next; j++) rank[order[j]] = j;
  for (int64_t i = 0; i < n; i++)
    if (codes[i] >= 0) codes[i] = rank[codes[i]];
  std::vector<uint8_t> arena(vocab_bytes, vocab_bytes + vb);
  std::vector<int64_t> off(vocab_off, vocab_off + next + 1);
  int64_t pos = 0;
  for (int32_t j = 0; j < next; j++) {
    int64_t a = off[order[j]], len = off[order[j] + 1] - a;
    memcpy(vocab_bytes + pos, arena.data() + a, static_cast<size_t>(len));
    pos += len;
    vocab_off[j + 1] = pos;
  }
  *vocab_bytes_used = vb;
  return next;
}

int64_t dict_encode(
    const uint8_t* bytes, const int64_t* offsets, const uint8_t* valid, int64_t n,
    int32_t* codes, int64_t* vocab_off, uint8_t* vocab_bytes, int64_t vocab_cap,
    int64_t* vocab_bytes_used) {
  try {
    return dict_encode_impl(bytes, offsets, valid, n, codes, vocab_off, vocab_bytes, vocab_cap,
                            vocab_bytes_used);
  } catch (...) {
    return -2;
  }
}

// ---------------------------------------------------------------------------
// Avro object-container ENCODE (the write half of the codec): columnar
// buffers → zigzag-varint record blocks (null, raw deflate, or raw snappy
// followed by the big-endian CRC32 of the uncompressed block) with sync
// markers.  Mirrors the Python writer's schema shape: every field is a
// [T, "null"] union (value branch 0).
// ---------------------------------------------------------------------------
static void write_varlong(std::vector<uint8_t>& out, int64_t v) {
  uint64_t z = (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
  while (z >= 0x80) {
    out.push_back(static_cast<uint8_t>(z) | 0x80);
    z >>= 7;
  }
  out.push_back(static_cast<uint8_t>(z));
}

static bool deflate_raw(const std::vector<uint8_t>& src, std::vector<uint8_t>& dst) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK) return false;
  dst.resize(deflateBound(&zs, static_cast<uLong>(src.size())));
  zs.next_in = const_cast<Bytef*>(src.data());
  zs.avail_in = static_cast<uInt>(src.size());
  zs.next_out = dst.data();
  zs.avail_out = static_cast<uInt>(dst.size());
  int rc = deflate(&zs, Z_FINISH);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return false;
  dst.resize(zs.total_out);
  return true;
}

static void emit_literal(const uint8_t* p, size_t len, std::vector<uint8_t>& out) {
  if (len == 0) return;
  uint32_t m = static_cast<uint32_t>(len - 1);
  if (m < 60) {
    out.push_back(static_cast<uint8_t>(m << 2));
  } else {
    int nb = m < (1u << 8) ? 1 : m < (1u << 16) ? 2 : m < (1u << 24) ? 3 : 4;
    out.push_back(static_cast<uint8_t>((59 + nb) << 2));
    for (int i = 0; i < nb; i++) out.push_back(static_cast<uint8_t>(m >> (8 * i)));
  }
  out.insert(out.end(), p, p + len);
}

// one copy element of 4..64 bytes: 1-byte offset form where it fits, else
// the 2-byte offset form (offsets stay below 65,536: one fragment)
static void emit_copy_upto64(uint32_t offset, uint32_t len, std::vector<uint8_t>& out) {
  if (len < 12 && offset < 2048) {
    out.push_back(static_cast<uint8_t>(1 | ((len - 4) << 2) | ((offset >> 8) << 5)));
    out.push_back(static_cast<uint8_t>(offset & 0xFF));
  } else {
    out.push_back(static_cast<uint8_t>(2 | ((len - 1) << 2)));
    out.push_back(static_cast<uint8_t>(offset & 0xFF));
    out.push_back(static_cast<uint8_t>(offset >> 8));
  }
}

static void emit_copy(uint32_t offset, uint32_t len, std::vector<uint8_t>& out) {
  while (len >= 68) { emit_copy_upto64(offset, 64, out); len -= 64; }
  if (len > 64) { emit_copy_upto64(offset, 60, out); len -= 60; }
  emit_copy_upto64(offset, len, out);
}

// raw snappy compress: the uncompressed length as a varint, then literal and
// copy elements from a greedy 4-byte hash match within each 64 KiB fragment
static void snappy_compress(const std::vector<uint8_t>& src, std::vector<uint8_t>& out) {
  const size_t n = src.size();
  out.clear();
  uint64_t v = n;
  while (v >= 0x80) { out.push_back(static_cast<uint8_t>(v) | 0x80); v >>= 7; }
  out.push_back(static_cast<uint8_t>(v));
  constexpr int kHashBits = 14;
  std::vector<uint16_t> table(1u << kHashBits);
  auto load32 = [](const uint8_t* p) { uint32_t x; memcpy(&x, p, 4); return x; };
  for (size_t frag = 0; frag < n; frag += 65536) {
    const uint8_t* base = src.data() + frag;
    const size_t fn = std::min<size_t>(65536, n - frag);
    std::fill(table.begin(), table.end(), 0);
    size_t lit = 0, i = 1;
    while (i + 4 <= fn) {
      uint32_t cur = load32(base + i);
      uint32_t h = (cur * 0x1E35A7BDu) >> (32 - kHashBits);
      size_t cand = table[h];
      table[h] = static_cast<uint16_t>(i);
      if (cand < i && load32(base + cand) == cur) {
        emit_literal(base + lit, i - lit, out);
        size_t len = 4;
        while (i + len < fn && base[cand + len] == base[i + len]) len++;
        emit_copy(static_cast<uint32_t>(i - cand), static_cast<uint32_t>(len), out);
        i += len;
        lit = i;
      } else {
        i++;
      }
    }
    emit_literal(base + lit, fn - lit, out);
  }
}

// Returns bytes written into `out`, or -1 (overflow) / -2 (codec error).
int64_t avro_encode(
    const int32_t* field_types, int32_t nfields, int64_t nrows,
    const double* const* doubles, const int64_t* const* longs,
    const uint8_t* const* valid,
    const int64_t* const* str_off, const uint8_t* const* str_bytes,
    int32_t codec, const uint8_t* sync, int64_t block_rows,
    uint8_t* out, int64_t out_cap) {
  try {
    std::vector<uint8_t> block, comp, framed;
    int64_t used = 0;
    for (int64_t start = 0; start < nrows; start += block_rows) {
      int64_t stop = start + block_rows < nrows ? start + block_rows : nrows;
      block.clear();
      for (int64_t i = start; i < stop; i++) {
        for (int32_t f = 0; f < nfields; f++) {
          bool ok = valid[f][i] != 0;
          write_varlong(block, ok ? 0 : 1);  // union branch: value first
          if (!ok) continue;
          switch (field_types[f]) {
            case FT_BOOL:
              block.push_back(doubles[f][i] != 0.0 ? 1 : 0);
              break;
            case FT_INT:
              write_varlong(block, longs[f][i]);
              break;
            case FT_DOUBLE: {
              double v = doubles[f][i];
              const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
              block.insert(block.end(), b, b + 8);
              break;
            }
            case FT_STRING: {
              int64_t a = str_off[f][i], b2 = str_off[f][i + 1];
              write_varlong(block, b2 - a);
              block.insert(block.end(), str_bytes[f] + a, str_bytes[f] + b2);
              break;
            }
            default:
              return -2;
          }
        }
      }
      const std::vector<uint8_t>* payload = &block;
      if (codec == 1) {
        if (!deflate_raw(block, comp)) return -2;
        payload = &comp;
      } else if (codec == 2) {
        snappy_compress(block, comp);
        uint32_t crc = static_cast<uint32_t>(
            crc32(0L, block.data(), static_cast<uInt>(block.size())));
        for (int s = 3; s >= 0; s--) comp.push_back(static_cast<uint8_t>(crc >> (8 * s)));
        payload = &comp;
      } else if (codec != 0) {
        return -2;
      }
      framed.clear();
      write_varlong(framed, stop - start);
      write_varlong(framed, static_cast<int64_t>(payload->size()));
      int64_t need = static_cast<int64_t>(framed.size() + payload->size()) + 16;
      if (used + need > out_cap) return -1;
      memcpy(out + used, framed.data(), framed.size());
      used += static_cast<int64_t>(framed.size());
      memcpy(out + used, payload->data(), payload->size());
      used += static_cast<int64_t>(payload->size());
      memcpy(out + used, sync, 16);
      used += 16;
    }
    return used;
  } catch (...) {
    return -2;
  }
}

// Connected components over an undirected edge list via union-find with
// path halving + union by size: O(E alpha(N)).  Replaces the per-combo
// scipy coo->csr->csc + BFS pass in the DBSCAN hyperparameter grid
// (reference geospatial cluster_analysis), whose conversion overhead
// dominated at 35 combos per grid.  The `minc`/`thresh` pair applies the
// min_samples core filter edge-by-edge (an edge joins the graph iff the
// smaller of its endpoint neighbor-counts reaches thresh — i.e. both ends
// are core), so one native pass per grid combo replaces the Python-side
// boolean compress + fancy gathers over the multi-million-edge list.
// Labels out[i] are dense component ids in FIRST-TOUCH order (ascending
// smallest member), matching scipy.sparse.csgraph.connected_components'
// labeling on the same graph.  Returns the component count, or -1 on bad
// input.
int64_t edge_components_minc(const int64_t* ei, const int64_t* ej,
                             const int64_t* minc, int64_t n_edges,
                             int64_t thresh, int64_t n_nodes, int64_t* out) {
  if (n_nodes < 0 || n_edges < 0) return -1;
  std::vector<int64_t> parent(n_nodes);
  std::vector<int64_t> size(n_nodes, 1);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };
  for (int64_t e = 0; e < n_edges; ++e) {
    if (minc[e] < thresh) continue;
    int64_t a = ei[e], b = ej[e];
    if (a < 0 || b < 0 || a >= n_nodes || b >= n_nodes) return -1;
    int64_t ra = find(a), rb = find(b);
    if (ra == rb) continue;
    if (size[ra] < size[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    size[ra] += size[rb];
  }
  // dense ids in first-touch order (the root of a set is NOT necessarily
  // its smallest member under union-by-size, so ids key off a root->id map
  // filled while scanning nodes in ascending order)
  std::vector<int64_t> comp(n_nodes, -1);
  int64_t next = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    int64_t r = find(i);
    if (comp[r] < 0) comp[r] = next++;
    out[i] = comp[r];
  }
  return next;
}

// (the unfiltered view lives in Python: native_edge_components delegates to
// edge_components_minc with minc := ei, thresh := INT64_MIN)

}  // extern "C"
