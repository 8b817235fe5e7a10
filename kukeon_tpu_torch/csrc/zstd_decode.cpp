// A zstd frame decoder (RFC 8878) in host C++17, with a plain C interface
// for ctypes, and the CRC-32C that OCDBT manifests and b-tree nodes end
// with. It reads the frames orbax writes (zarr chunks, OCDBT nodes) on the
// host, before the upload: zstd executes a frame's sequences in order, so
// the work is serial within a frame, and frames decode in parallel on
// reader threads (ctypes releases the GIL for the call).
//
// Coverage: frame headers with or without a content size and with any
// window, raw / RLE / compressed blocks, literals (raw, RLE, Huffman in one
// or four streams, treeless), sequences (predefined, RLE, FSE-compressed
// and repeat modes, repeat offsets), skippable and concatenated frames, and
// the optional XXH64 content checksum, which is checked. Dictionaries are
// refused. Every read is bounds-checked: a corrupt frame returns a negative
// error code, never reads or writes out of bounds. Output goes to a buffer
// the caller supplies.
//
// Entry points (all return a negative KZ_* code on error):
//   kukeon_zstd_frame_info(src, n, &size, &exact): the decoded size of every
//     frame in src, summed: exact when each frame header carries its content
//     size, else an upper bound from the block headers.
//   kukeon_zstd_decompress(src, n, dst, cap): decode every frame in src into
//     dst; returns the bytes written.
//   kukeon_crc32c(data, n, crc): CRC-32C (Castagnoli), chained through crc.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum : int64_t {
  KZ_OK = 0,
  KZ_SRC_TRUNCATED = -1,
  KZ_BAD_MAGIC = -2,
  KZ_BAD_FRAME_HEADER = -3,
  KZ_DICTIONARY = -4,
  KZ_BAD_BLOCK = -5,
  KZ_DST_TOO_SMALL = -6,
  KZ_BAD_LITERALS = -7,
  KZ_BAD_HUFFMAN = -8,
  KZ_BAD_FSE = -9,
  KZ_BAD_SEQUENCES = -10,
  KZ_BAD_OFFSET = -11,
  KZ_CHECKSUM = -12,
  KZ_SIZE_MISMATCH = -13,
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 1u << 17;  // 128 KiB

inline uint32_t rd16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | uint32_t(p[2]) << 16; }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | rd16(p + 2) << 16; }
inline uint64_t rd64(const uint8_t* p) { return uint64_t(rd32(p)) | uint64_t(rd32(p + 4)) << 32; }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------- XXH64 --

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p)); v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16)); v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1); h = xmerge(h, v2); h = xmerge(h, v3); h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) { h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3; p += 4; }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// --------------------------------------------------------- bit readers --

// Backward bitstream (FSE and Huffman streams): the encoder appends bits
// upwards and closes with a 1 bit; the decoder reads downwards from below
// that marker. Bits below the start of the stream read as zeros, and
// `pos` goes negative when a read consumed them: callers check it.
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t len = 0;
  int64_t pos = 0;  // unread bits

  bool init(const uint8_t* s, size_t n) {
    if (n == 0 || s[n - 1] == 0) return false;
    p = s; len = int64_t(n);
    pos = int64_t(n - 1) * 8 + highbit(s[n - 1]);
    return true;
  }
  // The nb (<= 56) bits below pos, as an integer.
  inline uint64_t peek(int nb) const {
    if (nb == 0) return 0;
    int64_t lo = pos - nb;
    int64_t byte = lo >> 3;  // floor, also for lo < 0
    uint64_t w;
    if (byte >= 0 && byte + 8 <= len) {
      w = rd64(p + byte);
    } else {
      w = 0;
      for (int i = 0; i < 8; ++i) {
        int64_t b = byte + i;
        if (b >= 0 && b < len) w |= uint64_t(p[b]) << (8 * i);
      }
    }
    return (w >> (lo & 7)) & ((uint64_t(1) << nb) - 1);
  }
  inline uint64_t read(int nb) { uint64_t v = peek(nb); pos -= nb; return v; }
};

// Forward bitstream (FSE table descriptions), little-endian, LSB first.
struct FwdBits {
  const uint8_t* p; size_t len; size_t pos = 0;  // pos in bits
  FwdBits(const uint8_t* s, size_t n) : p(s), len(n) {}
  uint32_t peek(int nb) const {  // nb <= 24; bits past the end read as 0
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      size_t b = (pos >> 3) + i;
      if (b < len) v |= uint32_t(p[b]) << (8 * i);
    }
    return (v >> (pos & 7)) & ((1u << nb) - 1);
  }
  void skip(int nb) { pos += nb; }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// ------------------------------------------------------------------ FSE --

struct FseEntry { uint16_t new_state; uint8_t symbol; uint8_t nb_bits; };

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool valid = false;

  // The one-symbol table of RLE mode.
  void rle(uint8_t s) { log = 0; t.assign(1, FseEntry{0, s, 0}); valid = true; }

  bool build(const int16_t* norm, int max_symbol, int table_log) {
    valid = false;
    const int size = 1 << table_log;
    t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint16_t> next(max_symbol + 1);
    int high = size - 1;
    for (int s = 0; s <= max_symbol; ++s) {
      if (norm[s] == -1) {
        if (high < 0) return false;
        t[high--].symbol = uint8_t(s);
        next[s] = 1;
      } else {
        next[s] = uint16_t(norm[s] < 0 ? 0 : norm[s]);
      }
    }
    const int mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
    int pos = 0;
    for (int s = 0; s <= max_symbol; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        t[pos].symbol = uint8_t(s);
        do { pos = (pos + step) & mask; } while (pos > high);
      }
    }
    if (pos != 0) return false;
    for (int u = 0; u < size; ++u) {
      const int s = t[u].symbol;
      const uint32_t ns = next[s]++;
      if (ns == 0) return false;
      const int nb = table_log - highbit(ns);
      t[u].nb_bits = uint8_t(nb);
      t[u].new_state = uint16_t((ns << nb) - size);
    }
    log = table_log;
    valid = true;
    return true;
  }
};

// Reads an FSE table description (normalized counts) from src; returns the
// bytes it took, or a negative code.
int64_t read_fse_table(const uint8_t* src, size_t n, int max_symbol, int max_log,
                       FseTable& out) {
  if (n == 0) return KZ_BAD_FSE;
  FwdBits br(src, n);
  const int log = int(br.peek(4)) + 5;
  br.skip(4);
  if (log > max_log) return KZ_BAD_FSE;
  int16_t norm[256] = {0};
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1, s = 0;
  bool prev0 = false;
  while (remaining > 1 && s <= max_symbol) {
    if (prev0) {
      int n0 = s;
      for (;;) {
        const uint32_t r = br.peek(2);
        br.skip(2);
        n0 += int(r);
        if (r != 3) break;
        if (br.pos > n * 8) return KZ_BAD_FSE;
      }
      if (n0 > max_symbol) return KZ_BAD_FSE;
      while (s < n0) norm[s++] = 0;
      if (s > max_symbol) break;
    }
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const uint32_t low = br.peek(nb - 1);
    if (int(low) < max) {
      count = int(low);
      br.skip(nb - 1);
    } else {
      count = int(br.peek(nb));
      if (count >= threshold) count -= max;
      br.skip(nb);
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[s++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold && nb > 1) { nb--; threshold >>= 1; }
    if (br.pos > n * 8) return KZ_BAD_FSE;
  }
  if (remaining != 1 || br.pos > n * 8) return KZ_BAD_FSE;
  if (!out.build(norm, s - 1, log)) return KZ_BAD_FSE;
  return int64_t(br.bytes_used());
}

// -------------------------------------------------------------- Huffman --

struct HufEntry { uint8_t symbol; uint8_t nb_bits; };

struct HufTable {
  int log = 0;
  std::vector<HufEntry> t;
  bool valid = false;
};

// Builds the decoding table from one weight per symbol (the last one
// implied); false when the weights do not describe a complete code.
bool build_huffman(const uint8_t* weights, int n, HufTable& out) {
  out.valid = false;
  if (n < 1 || n > 255) return false;
  uint32_t total = 0;
  int rank[13] = {0};
  for (int i = 0; i < n; ++i) {
    if (weights[i] > 11) return false;
    if (weights[i]) total += 1u << (weights[i] - 1);
    rank[weights[i]]++;
  }
  if (total == 0) return false;
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) return false;
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) return false;
  const int last = highbit(rest) + 1;
  rank[last]++;
  if (rank[1] < 2 || (rank[1] & 1)) return false;
  uint8_t w[256];
  std::memcpy(w, weights, n);
  w[n] = uint8_t(last);
  const int nsym = n + 1;
  int start[13] = {0};
  for (int k = 1, next = 0; k <= max_bits; ++k) { start[k] = next; next += rank[k] << (k - 1); }
  out.t.assign(size_t(1) << max_bits, HufEntry{0, 0});
  for (int s = 0; s < nsym; ++s) {
    const int k = w[s];
    if (!k) continue;
    const int len = 1 << (k - 1);
    for (int i = 0; i < len; ++i)
      out.t[start[k] + i] = HufEntry{uint8_t(s), uint8_t(max_bits + 1 - k)};
    start[k] += len;
  }
  out.log = max_bits;
  out.valid = true;
  return true;
}

// Reads a Huffman tree description; returns its size in bytes.
int64_t read_huffman_tree(const uint8_t* src, size_t n, HufTable& out) {
  if (n < 1) return KZ_BAD_HUFFMAN;
  const int header = src[0];
  uint8_t weights[256];
  int nw = 0;
  size_t used;
  if (header >= 128) {
    nw = header - 127;
    used = 1 + size_t((nw + 1) / 2);
    if (used > n) return KZ_SRC_TRUNCATED;
    for (int i = 0; i < nw; ++i) {
      const uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    used = 1 + size_t(header);
    if (header == 0 || used > n) return KZ_BAD_HUFFMAN;
    FseTable fse;
    const int64_t th = read_fse_table(src + 1, header, 255, 6, fse);
    if (th < 0) return th;
    BackBits br;
    if (!br.init(src + 1 + th, size_t(header - th))) return KZ_BAD_HUFFMAN;
    uint32_t s1 = uint32_t(br.read(fse.log)), s2 = uint32_t(br.read(fse.log));
    if (br.pos < 0) return KZ_BAD_HUFFMAN;
    // Two interleaved states, until a state update reads past the start.
    for (;;) {
      if (nw > 253) return KZ_BAD_HUFFMAN;
      const FseEntry& e1 = fse.t[s1];
      weights[nw++] = e1.symbol;
      s1 = e1.new_state + uint32_t(br.read(e1.nb_bits));
      if (br.pos < 0) { weights[nw++] = fse.t[s2].symbol; break; }
      const FseEntry& e2 = fse.t[s2];
      weights[nw++] = e2.symbol;
      s2 = e2.new_state + uint32_t(br.read(e2.nb_bits));
      if (br.pos < 0) { weights[nw++] = fse.t[s1].symbol; break; }
    }
  }
  if (!build_huffman(weights, nw, out)) return KZ_BAD_HUFFMAN;
  return int64_t(used);
}

// One Huffman stream being decoded: its bits, where its symbols go, how
// many it owes and how many it has written.
struct HufStream {
  BackBits br;
  uint8_t* dst = nullptr;
  size_t count = 0, i = 0;
};

// While 56 bits below pos lie inside the stream, 5 symbols (at most 55
// bits) decode from one load.
inline bool huf_can5(const HufStream& s) { return s.i + 5 <= s.count && s.br.pos >= 56; }

inline void huf_decode5(const HufEntry* t, int log, uint64_t mask, HufStream& s) {
  const int64_t lo = s.br.pos - 56;
  const uint64_t w = rd64(s.br.p + (lo >> 3)) >> (lo & 7);
  int avail = 56;
  for (int k = 0; k < 5; ++k) {
    const HufEntry& e = t[(w >> (avail - log)) & mask];
    s.dst[s.i++] = e.symbol;
    avail -= e.nb_bits;
  }
  s.br.pos -= 56 - avail;
}

// Decodes what the stream still owes; true when it ends exactly at the
// start of its bits.
bool huf_finish(const HufTable& h, HufStream& s) {
  const uint64_t mask = (uint64_t(1) << h.log) - 1;
  while (huf_can5(s)) huf_decode5(h.t.data(), h.log, mask, s);
  for (; s.i < s.count; ++s.i) {
    const HufEntry& e = h.t[s.br.peek(h.log)];
    s.dst[s.i] = e.symbol;
    s.br.pos -= e.nb_bits;
  }
  return s.br.pos == 0;
}

// The four streams' symbols in turn while each can take 5 at once: their
// chains of table lookups are independent, so the core overlaps them. The
// cursors live in locals (a store through a byte pointer may alias any
// field), then each stream finishes alone.
bool huffman_4streams(const HufTable& h, HufStream* s) {
  const uint64_t mask = (uint64_t(1) << h.log) - 1;
  const HufEntry* t = h.t.data();
  const int log = h.log;
  int64_t pos[4];
  size_t i[4], count[4];
  const uint8_t* src[4];
  uint8_t* dst[4];
  for (int k = 0; k < 4; ++k) {
    pos[k] = s[k].br.pos; i[k] = s[k].i; count[k] = s[k].count;
    src[k] = s[k].br.p; dst[k] = s[k].dst;
  }
  auto can5 = [&](int k) { return i[k] + 5 <= count[k] && pos[k] >= 56; };
  while (can5(0) && can5(1) && can5(2) && can5(3)) {
    for (int k = 0; k < 4; ++k) {
      const int64_t lo = pos[k] - 56;
      const uint64_t w = rd64(src[k] + (lo >> 3)) >> (lo & 7);
      int avail = 56;
      uint8_t sym[5];
      for (int j = 0; j < 5; ++j) {
        const HufEntry e = t[(w >> (avail - log)) & mask];
        sym[j] = e.symbol;
        avail -= e.nb_bits;
      }
      std::memcpy(dst[k] + i[k], sym, 5);
      i[k] += 5;
      pos[k] -= 56 - avail;
    }
  }
  for (int k = 0; k < 4; ++k) {
    s[k].br.pos = pos[k];
    s[k].i = i[k];
    if (!huf_finish(h, s[k])) return false;
  }
  return true;
}

// ------------------------------------------------------------ sequences --

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                                2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                                -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                                -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                              16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512,
                              1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                             13, 14, 15, 16};
const uint32_t kMLBase[53] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
                              19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
                              35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                              1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                             12, 13, 14, 15, 16};

// ---------------------------------------------------------------- frame --

// State that lives across the blocks of one frame.
struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lit;  // decoded literals of the current block
};

int64_t decode_table(const uint8_t*& ip, const uint8_t* end, int mode, int max_symbol,
                     int max_log, const int16_t* def, int def_max, int def_log, FseTable& t) {
  switch (mode) {
    case 0:  // predefined
      if (!t.build(def, def_max, def_log)) return KZ_BAD_FSE;
      return KZ_OK;
    case 1:  // RLE
      if (ip >= end) return KZ_SRC_TRUNCATED;
      if (*ip > max_symbol) return KZ_BAD_SEQUENCES;
      t.rle(*ip++);
      return KZ_OK;
    case 2: {  // FSE-compressed
      const int64_t used = read_fse_table(ip, size_t(end - ip), max_symbol, max_log, t);
      if (used < 0) return used;
      ip += used;
      return KZ_OK;
    }
    default:  // repeat: the previous block's table
      return t.valid ? KZ_OK : KZ_BAD_SEQUENCES;
  }
}

// Decodes one compressed block into out[0 .. cap), out being preceded by
// `history` bytes of the frame's output; returns the bytes written.
int64_t decode_block(FrameState& fs, const uint8_t* src, size_t n, uint8_t* out, size_t cap,
                     size_t history) {
  const uint8_t* ip = src;
  const uint8_t* end = src + n;
  if (n < 1) return KZ_SRC_TRUNCATED;
  // Literals section.
  const int ltype = ip[0] & 3, sfmt = (ip[0] >> 2) & 3;
  size_t regen, csize = 0, hsize;
  int streams = 1;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) { hsize = 1; regen = ip[0] >> 3; }
    else if (sfmt == 1) { hsize = 2; if (n < 2) return KZ_SRC_TRUNCATED; regen = rd16(ip) >> 4; }
    else { hsize = 3; if (n < 3) return KZ_SRC_TRUNCATED; regen = rd24(ip) >> 4; }
  } else {
    if (sfmt < 2) {
      hsize = 3; if (n < 3) return KZ_SRC_TRUNCATED;
      const uint32_t c = rd24(ip);
      regen = (c >> 4) & 0x3FF; csize = (c >> 14) & 0x3FF; streams = sfmt == 0 ? 1 : 4;
    } else if (sfmt == 2) {
      hsize = 4; if (n < 4) return KZ_SRC_TRUNCATED;
      const uint32_t c = rd32(ip);
      regen = (c >> 4) & 0x3FFF; csize = c >> 18; streams = 4;
    } else {
      hsize = 5; if (n < 5) return KZ_SRC_TRUNCATED;
      const uint64_t c = uint64_t(rd32(ip)) | uint64_t(ip[4]) << 32;
      regen = (c >> 4) & 0x3FFFF; csize = (c >> 22) & 0x3FFFF; streams = 4;
    }
  }
  if (regen > kBlockMax) return KZ_BAD_LITERALS;
  ip += hsize;
  const uint8_t* lits;
  if (ltype == 0) {
    if (size_t(end - ip) < regen) return KZ_SRC_TRUNCATED;
    lits = ip;
    ip += regen;
  } else if (ltype == 1) {
    if (ip >= end) return KZ_SRC_TRUNCATED;
    fs.lit.assign(regen, *ip++);
    lits = fs.lit.data();
  } else {
    if (size_t(end - ip) < csize) return KZ_SRC_TRUNCATED;
    const uint8_t* cp = ip;
    size_t cn = csize;
    if (ltype == 2) {
      const int64_t used = read_huffman_tree(cp, cn, fs.huf);
      if (used < 0) return used;
      cp += used; cn -= size_t(used);
    } else if (!fs.huf.valid) {
      return KZ_BAD_LITERALS;
    }
    fs.lit.resize(regen + 8);
    if (streams == 1) {
      HufStream one;
      one.dst = fs.lit.data();
      one.count = regen;
      if (!one.br.init(cp, cn) || !huf_finish(fs.huf, one)) return KZ_BAD_HUFFMAN;
    } else {
      if (cn < 10) return KZ_BAD_LITERALS;
      const size_t s1 = rd16(cp), s2 = rd16(cp + 2), s3 = rd16(cp + 4);
      if (s1 + s2 + s3 + 6 >= cn) return KZ_BAD_LITERALS;
      const size_t s4 = cn - 6 - s1 - s2 - s3;
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) return KZ_BAD_LITERALS;
      const uint8_t* sp = cp + 6;
      const size_t sizes[4] = {s1, s2, s3, s4};
      HufStream four[4];
      for (int k = 0; k < 4; ++k) {
        four[k].dst = fs.lit.data() + k * seg;
        four[k].count = k < 3 ? seg : regen - 3 * seg;
        if (!four[k].br.init(sp, sizes[k])) return KZ_BAD_HUFFMAN;
        sp += sizes[k];
      }
      if (!huffman_4streams(fs.huf, four)) return KZ_BAD_HUFFMAN;
    }
    lits = fs.lit.data();
    ip += csize;
  }

  // Sequences section.
  if (ip >= end) return KZ_SRC_TRUNCATED;
  size_t nseq = ip[0];
  if (nseq < 128) {
    ip += 1;
  } else if (nseq < 255) {
    if (end - ip < 2) return KZ_SRC_TRUNCATED;
    nseq = ((nseq - 128) << 8) + ip[1];
    ip += 2;
  } else {
    if (end - ip < 3) return KZ_SRC_TRUNCATED;
    nseq = rd16(ip + 1) + 0x7F00;
    ip += 3;
  }
  size_t op = 0;
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (ip >= end) return KZ_SRC_TRUNCATED;
    const int modes = *ip++;
    if (modes & 3) return KZ_BAD_SEQUENCES;
    // (mode, max symbol, max accuracy log, predefined table, its max
    // symbol and accuracy log) for literal lengths, offsets, match lengths.
    int64_t r;
    if ((r = decode_table(ip, end, (modes >> 6) & 3, 35, 9, kLLDefault, 35, 6, fs.ll)) < 0)
      return r;
    if ((r = decode_table(ip, end, (modes >> 4) & 3, 31, 8, kOFDefault, 28, 5, fs.of)) < 0)
      return r;
    if ((r = decode_table(ip, end, (modes >> 2) & 3, 52, 9, kMLDefault, 52, 6, fs.ml)) < 0)
      return r;
    BackBits br;
    if (!br.init(ip, size_t(end - ip))) return KZ_BAD_SEQUENCES;
    uint32_t sll = uint32_t(br.read(fs.ll.log));
    uint32_t sof = uint32_t(br.read(fs.of.log));
    uint32_t sml = uint32_t(br.read(fs.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry& ell = fs.ll.t[sll];
      const FseEntry& eof = fs.of.t[sof];
      const FseEntry& eml = fs.ml.t[sml];
      const int ofc = eof.symbol;
      if (ofc > 31 || ell.symbol > 35 || eml.symbol > 52) return KZ_BAD_SEQUENCES;
      const uint64_t ov = (uint64_t(1) << ofc) + br.read(ofc);
      const size_t ml = kMLBase[eml.symbol] + size_t(br.read(kMLBits[eml.symbol]));
      const size_t ll = kLLBase[ell.symbol] + size_t(br.read(kLLBits[ell.symbol]));
      uint64_t offset;
      if (ov > 3) {
        offset = ov - 3;
        fs.rep[2] = fs.rep[1]; fs.rep[1] = fs.rep[0]; fs.rep[0] = offset;
      } else {
        const int idx = int(ov) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = fs.rep[0];
        } else {
          offset = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
          if (idx != 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = ell.new_state + uint32_t(br.read(ell.nb_bits));
        sml = eml.new_state + uint32_t(br.read(eml.nb_bits));
        sof = eof.new_state + uint32_t(br.read(eof.nb_bits));
      }
      if (br.pos < 0) return KZ_BAD_SEQUENCES;
      // Execute: ll literals, then ml bytes from `offset` back.
      if (ll > regen - lit_pos) return KZ_BAD_SEQUENCES;
      if (ll + ml > cap - op) return KZ_DST_TOO_SMALL;
      std::memcpy(out + op, lits + lit_pos, ll);
      op += ll; lit_pos += ll;
      if (offset == 0 || offset > history + op) return KZ_BAD_OFFSET;
      uint8_t* d = out + op;
      const uint8_t* s = d - offset;
      if (offset >= ml) {
        std::memcpy(d, s, ml);
      } else {
        for (size_t k = 0; k < ml; ++k) d[k] = s[k];
      }
      op += ml;
    }
    if (br.pos != 0) return KZ_BAD_SEQUENCES;
  } else if (ip != end) {
    return KZ_BAD_SEQUENCES;
  }
  const size_t tail = regen - lit_pos;
  if (tail > cap - op) return KZ_DST_TOO_SMALL;
  std::memcpy(out + op, lits + lit_pos, tail);
  op += tail;
  return int64_t(op);
}

struct FrameHeader {
  size_t size = 0;           // header bytes after the magic
  uint64_t content = 0;      // content size when has_content
  bool has_content = false;
  bool checksum = false;
  uint64_t window = 0;
};

int64_t parse_frame_header(const uint8_t* p, size_t n, FrameHeader& h) {
  if (n < 1) return KZ_SRC_TRUNCATED;
  const int fhd = p[0];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  if (fhd & 8) return KZ_BAD_FRAME_HEADER;  // reserved bit
  h.checksum = (fhd >> 2) & 1;
  size_t pos = 1;
  if (!single) {
    if (n < 2) return KZ_SRC_TRUNCATED;
    const int wd = p[1];
    const int wlog = 10 + (wd >> 3);
    if (wlog > 41) return KZ_BAD_FRAME_HEADER;
    const uint64_t base = uint64_t(1) << wlog;
    h.window = base + (base / 8) * uint64_t(wd & 7);
    pos = 2;
  }
  static const int did_size[4] = {0, 1, 2, 4};
  if (n < pos + did_size[did_flag]) return KZ_SRC_TRUNCATED;
  uint32_t did = 0;
  for (int i = 0; i < did_size[did_flag]; ++i) did |= uint32_t(p[pos + i]) << (8 * i);
  pos += did_size[did_flag];
  if (did != 0) return KZ_DICTIONARY;
  const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (n < pos + fcs_size) return KZ_SRC_TRUNCATED;
  switch (fcs_size) {
    case 1: h.content = p[pos]; break;
    case 2: h.content = rd16(p + pos) + 256; break;
    case 4: h.content = rd32(p + pos); break;
    case 8: h.content = rd64(p + pos); break;
    default: break;
  }
  h.has_content = fcs_size > 0;
  pos += fcs_size;
  if (single) h.window = h.content;
  h.size = pos;
  return KZ_OK;
}

// Walks (dst == nullptr) or decodes every frame of src. `size` gets the
// decoded size (the bound when walking), `exact` whether every frame
// declared its content size.
int64_t run(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, uint64_t* size, int* exact) {
  size_t ip = 0;
  uint64_t total = 0;
  bool all_exact = true;
  FrameState fs;
  if (n == 0) return KZ_SRC_TRUNCATED;
  while (ip < n) {
    if (n - ip < 4) return KZ_SRC_TRUNCATED;
    const uint32_t magic = rd32(src + ip);
    if ((magic & kSkippableMask) == kSkippableMagic) {
      if (n - ip < 8) return KZ_SRC_TRUNCATED;
      const uint64_t skip = rd32(src + ip + 4);
      if (n - ip - 8 < skip) return KZ_SRC_TRUNCATED;
      ip += 8 + size_t(skip);
      continue;
    }
    if (magic != kMagic) return KZ_BAD_MAGIC;
    ip += 4;
    FrameHeader h;
    int64_t r = parse_frame_header(src + ip, n - ip, h);
    if (r < 0) return r;
    ip += h.size;
    const size_t block_max = size_t(h.window < kBlockMax ? h.window : kBlockMax);
    const uint64_t frame_start = total;
    uint64_t bound = 0;
    fs.huf.valid = fs.ll.valid = fs.of.valid = fs.ml.valid = false;
    fs.rep[0] = 1; fs.rep[1] = 4; fs.rep[2] = 8;
    for (bool last = false; !last;) {
      if (n - ip < 3) return KZ_SRC_TRUNCATED;
      const uint32_t bh = rd24(src + ip);
      ip += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t bsize = bh >> 3;
      if (type == 3) return KZ_BAD_BLOCK;
      if (bsize > kBlockMax) return KZ_BAD_BLOCK;
      const size_t in_size = type == 1 ? 1 : bsize;
      if (n - ip < in_size) return KZ_SRC_TRUNCATED;
      if (dst == nullptr) {
        bound += type == 2 ? block_max : bsize;
      } else {
        uint8_t* out = dst + total;
        const size_t room = cap - size_t(total);
        if (type == 0 || type == 1) {
          if (bsize > block_max) return KZ_BAD_BLOCK;
          if (bsize > room) return KZ_DST_TOO_SMALL;
          if (type == 0) std::memcpy(out, src + ip, bsize);
          else std::memset(out, src[ip], bsize);
          total += bsize;
        } else {
          // A block regenerates at most block_max bytes: past that it is
          // corrupt, short of it the caller's buffer is too small.
          r = decode_block(fs, src + ip, bsize, out, room < block_max ? room : block_max,
                           size_t(total - frame_start));
          if (r == KZ_DST_TOO_SMALL && room >= block_max) r = KZ_BAD_BLOCK;
          if (r < 0) return r;
          total += uint64_t(r);
        }
      }
      ip += in_size;
    }
    if (h.checksum) {
      if (n - ip < 4) return KZ_SRC_TRUNCATED;
      if (dst != nullptr) {
        const uint32_t want = rd32(src + ip);
        const uint32_t got = uint32_t(xxh64(dst + frame_start, size_t(total - frame_start)));
        if (want != got) return KZ_CHECKSUM;
      }
      ip += 4;
    }
    if (dst == nullptr) {
      if (h.has_content) {
        if (h.content > bound) return KZ_SIZE_MISMATCH;
        total += h.content;
      } else {
        total += bound;
        all_exact = false;
      }
    } else if (h.has_content && total - frame_start != h.content) {
      return KZ_SIZE_MISMATCH;
    }
  }
  if (size) *size = total;
  if (exact) *exact = all_exact ? 1 : 0;
  return KZ_OK;
}

// --------------------------------------------------------------- CRC-32C --

struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables kCrc;

}  // namespace

extern "C" {

int64_t kukeon_zstd_frame_info(const uint8_t* src, uint64_t n, uint64_t* size, int* exact) {
  return run(src, size_t(n), nullptr, 0, size, exact);
}

int64_t kukeon_zstd_decompress(const uint8_t* src, uint64_t n, uint8_t* dst, uint64_t cap) {
  uint64_t size = 0;
  const int64_t r = run(src, size_t(n), dst, size_t(cap), &size, nullptr);
  return r < 0 ? r : int64_t(size);
}

uint32_t kukeon_crc32c(const uint8_t* p, uint64_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    const uint32_t lo = rd32(p) ^ crc, hi = rd32(p + 4);
    crc = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^ kCrc.t[5][(lo >> 16) & 0xFF] ^
          kCrc.t[4][lo >> 24] ^ kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
          kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
    p += 8; n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

}  // extern "C"
