// Zstandard decoder (RFC 8878, decode only) and CRC-32C, with a plain C ABI
// for ctypes (relativepose_tpu_torch/native/zstd.py).
//
//   int64_t  rp_zstd_content_size(src, n)      sum of the frames' declared
//            content sizes; RP_UNKNOWN (-9) when a frame declares none
//   int64_t  rp_zstd_decompress_bound(src, n)  an upper bound of the output
//   int64_t  rp_zstd_decompress(src, n, dst, cap)  bytes written
//   uint32_t rp_crc32c(src, n)                 CRC-32C (Castagnoli)
//
// A negative result is one of the error codes below.  Every read stays in
// [src, src + n) and every write in [dst, dst + cap): malformed input,
// a dictionary, a reserved bit or a checksum mismatch return a code, never
// an assertion or an abort.  Frames may be concatenated and interleaved
// with skippable frames.  A match may reach back only into the output of
// its own frame, since no dictionary is ever loaded.

#include <cstdint>
#include <cstring>
#include <new>

namespace {

enum : int64_t {
  E_TRUNCATED = -1,     // input ends inside a frame, or holds no frame
  E_MAGIC = -2,         // not a zstd or skippable frame
  E_RESERVED = -3,      // a reserved bit or block type is set
  E_DICTIONARY = -4,    // the frame needs a dictionary
  E_CORRUPT = -5,       // inconsistent compressed data
  E_DST_SIZE = -6,      // output buffer too small
  E_CHECKSUM = -7,      // content checksum mismatch
  E_CONTENT_SIZE = -8,  // decoded size differs from the declared size
  E_UNKNOWN = -9,       // (content size only) a frame declares no size
  E_MEMORY = -10,       // the decoder's work area could not be allocated
};

struct Fail {
  int64_t code;
};
[[noreturn]] inline void fail(int64_t code) { throw Fail{code}; }

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr size_t kBlockMax = 1 << 17;

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts (x86-64, aarch64)
  return v;
}
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------- bit input

// Forward little-endian bits (FSE table descriptions); zeros past the end,
// the caller checks `bit` against the input's size.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t peek(int k) const {  // k <= 24
    uint32_t v = 0;
    size_t byte = bit >> 3;
    for (int i = 0; i < 4 && byte + i < n; i++) v |= uint32_t(p[byte + i]) << (8 * i);
    return (v >> (bit & 7)) & ((1u << k) - 1);
  }
  void skip(int k) { bit += k; }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    bit += k;
    return v;
  }
};

// Backward bits (Huffman streams and sequences): the stream is read from
// its last byte, whose highest set bit marks where the bits start.  Bits
// past the start read as zeros; `remaining()` goes negative then.
struct BackBits {
  const uint8_t* start;
  const uint8_t* ptr;  // the container holds the 8 bytes at ptr
  uint64_t c;
  unsigned used;  // bits of the container already read, from the top

  void init(const uint8_t* s, size_t n) {
    if (n == 0 || s[n - 1] == 0) fail(E_CORRUPT);
    start = s;
    if (n >= 8) {
      ptr = s + n - 8;
      c = rd64(ptr);
      used = 0;
    } else {
      ptr = s;
      c = 0;
      for (size_t i = 0; i < n; i++) c |= uint64_t(s[i]) << (8 * i);
      used = unsigned(8 - n) * 8;
    }
    used += 8 - highbit(s[n - 1]);
  }
  inline uint64_t look(unsigned nb) const {  // nb <= 57 after a reload
    return ((c << (used & 63)) >> 1) >> ((63 - nb) & 63);
  }
  inline uint64_t read(unsigned nb) {
    uint64_t v = look(nb);
    used += nb;
    return v;
  }
  inline void reload() {
    if (used > 64) return;  // overread: stays so
    if (ptr >= start + 8) {
      ptr -= used >> 3;
      used &= 7;
    } else {
      if (ptr == start) return;
      size_t nb = used >> 3;
      if (size_t(ptr - start) < nb) nb = ptr - start;
      ptr -= nb;
      used -= unsigned(nb) * 8;
    }
    c = rd64(ptr);
  }
  int64_t remaining() const { return int64_t(ptr - start) * 8 + 64 - int64_t(used); }
};

// ---------------------------------------------------------------- FSE

struct FseEntry {
  uint16_t base;  // next state = base + bits read
  uint8_t symbol;
  uint8_t nbits;
};
struct FseTable {
  int log = 0;
  FseEntry t[1 << 9];
};

// An FSE table description: normalized counts for symbols 0..maxSym.
// Returns the bytes it takes; `maxSym` becomes the last symbol described.
size_t read_ncount(const uint8_t* src, size_t n, int16_t* norm, int& maxSym,
                   int& log, int maxLog) {
  FwdBits br{src, n};
  const int maxAllowed = maxSym;
  log = int(br.read(4)) + 5;
  if (log > maxLog) fail(E_CORRUPT);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= maxAllowed) {
    if (prev0) {
      int n0 = sym;
      while (br.peek(2) == 3) {
        n0 += 3;
        br.skip(2);
        if (n0 > maxAllowed) fail(E_CORRUPT);
      }
      n0 += int(br.read(2));
      if (n0 > maxAllowed) fail(E_CORRUPT);
      while (sym < n0) norm[sym++] = 0;
      if (br.bit > 8 * n) fail(E_TRUNCATED);
    }
    const int max = (2 * threshold - 1) - remaining;
    uint32_t v = br.peek(nbits);
    int count;
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      br.skip(nbits - 1);
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      br.skip(nbits);
    }
    count--;  // -1: probability "less than 1"
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail(E_CORRUPT);
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    if (br.bit > 8 * n) fail(E_TRUNCATED);
  }
  if (remaining != 1) fail(E_CORRUPT);
  maxSym = sym - 1;
  return (br.bit + 7) >> 3;
}

void fse_build(FseTable& T, const int16_t* norm, int maxSym, int log) {
  const int size = 1 << log;
  int high = size - 1, total = 0;
  uint16_t next[256];
  for (int s = 0; s <= maxSym; s++) {
    if (norm[s] == -1) {
      T.t[high--].symbol = uint8_t(s);
      next[s] = 1;
      total++;
    } else {
      next[s] = uint16_t(norm[s]);
      total += norm[s];
    }
  }
  if (total != size) fail(E_CORRUPT);
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= maxSym; s++)
    for (int i = 0; i < norm[s]; i++) {
      T.t[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  if (pos != 0) fail(E_CORRUPT);
  for (int u = 0; u < size; u++) {
    uint32_t ns = next[T.t[u].symbol]++;
    int nb = log - highbit(ns);
    T.t[u].nbits = uint8_t(nb);
    T.t[u].base = uint16_t((ns << nb) - size);
  }
  T.log = log;
}

void fse_rle(FseTable& T, uint8_t symbol) {
  T.log = 0;
  T.t[0] = FseEntry{0, symbol, 0};
}

inline uint8_t fse_decode(const FseTable& T, unsigned& state, BackBits& br) {
  const FseEntry e = T.t[state];
  state = e.base + unsigned(br.read(e.nbits));
  return e.symbol;
}

// ---------------------------------------------------------------- Huffman

struct HufEntry {
  uint8_t symbol;
  uint8_t nbits;
};
struct HufTable {
  int maxBits = 0;
  HufEntry t[1 << 11];
};

void huf_build(HufTable& H, const uint8_t* w, int nw) {
  uint32_t rank[13] = {0}, sum = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > 11) fail(E_CORRUPT);
    rank[w[i]]++;
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) fail(E_CORRUPT);
  const int maxBits = highbit(sum) + 1;
  if (maxBits > 11) fail(E_CORRUPT);
  const uint32_t left = (1u << maxBits) - sum;  // the last, implied weight
  if (left & (left - 1)) fail(E_CORRUPT);
  const int lastW = highbit(left) + 1;
  rank[lastW]++;
  if (rank[1] < 2 || (rank[1] & 1)) fail(E_CORRUPT);
  uint32_t startAt[13], next = 0;
  for (int k = 1; k <= maxBits; k++) {
    startAt[k] = next;
    next += rank[k] << (k - 1);
  }
  for (int s = 0; s <= nw; s++) {
    const int k = s < nw ? w[s] : lastW;
    if (!k) continue;
    const uint32_t len = 1u << (k - 1);
    const HufEntry e{uint8_t(s), uint8_t(maxBits + 1 - k)};
    for (uint32_t u = startAt[k]; u < startAt[k] + len; u++) H.t[u] = e;
    startAt[k] += len;
  }
  H.maxBits = maxBits;
}

// A Huffman tree description; returns the bytes it takes.
size_t huf_read(const uint8_t* src, size_t n, HufTable& H) {
  if (n < 1) fail(E_TRUNCATED);
  uint8_t w[256];
  int nw = 0;
  const int hb = src[0];
  if (hb >= 128) {  // weights as 4-bit fields
    nw = hb - 127;
    const size_t bytes = (size_t(nw) + 1) / 2;
    if (1 + bytes > n) fail(E_TRUNCATED);
    for (int i = 0; i < nw; i++) w[i] = (i & 1) ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4;
    huf_build(H, w, nw);
    return 1 + bytes;
  }
  // FSE-compressed weights, two interleaved states
  const size_t csize = size_t(hb);
  if (csize == 0) fail(E_CORRUPT);
  if (1 + csize > n) fail(E_TRUNCATED);
  int16_t norm[16];
  int maxSym = 15, log;
  const size_t h = read_ncount(src + 1, csize, norm, maxSym, log, 6);
  if (h >= csize) fail(E_CORRUPT);
  FseTable T;
  fse_build(T, norm, maxSym, log);
  BackBits br;
  br.init(src + 1 + h, csize - h);
  unsigned s1 = unsigned(br.read(log)), s2 = unsigned(br.read(log));
  br.reload();
  while (true) {
    if (nw > 253) fail(E_CORRUPT);
    w[nw++] = fse_decode(T, s1, br);
    br.reload();
    if (br.remaining() < 0) {
      w[nw++] = T.t[s2].symbol;
      break;
    }
    w[nw++] = fse_decode(T, s2, br);
    br.reload();
    if (br.remaining() < 0) {
      w[nw++] = T.t[s1].symbol;
      break;
    }
  }
  huf_build(H, w, nw);
  return 1 + csize;
}

inline void huf_symbol(const HufTable& H, BackBits& br, uint8_t*& op) {
  const HufEntry e = H.t[br.look(unsigned(H.maxBits))];
  *op++ = e.symbol;
  br.used += e.nbits;
}

// Finishes one stream at op..oend; every bit must be read.
void huf_tail(const HufTable& H, BackBits& br, uint8_t* op, uint8_t* const oend) {
  while (oend - op >= 4) {
    br.reload();
    for (int i = 0; i < 4; i++) huf_symbol(H, br, op);
  }
  while (op < oend) {
    br.reload();
    huf_symbol(H, br, op);
  }
  br.reload();
  if (br.remaining() != 0) fail(E_CORRUPT);
}

void huf_stream(const HufTable& H, const uint8_t* src, size_t n, uint8_t* op, size_t len) {
  BackBits br;
  br.init(src, n);
  huf_tail(H, br, op, op + len);
}

// Four streams, decoded interleaved while all four have output left.
void huf_streams4(const HufTable& H, const uint8_t* const src[4], const size_t n[4],
                  uint8_t* const out, size_t seg, size_t last) {
  BackBits br[4];
  uint8_t* op[4];
  for (int k = 0; k < 4; k++) {
    br[k].init(src[k], n[k]);
    op[k] = out + k * seg;
  }
  for (size_t i = 0; i + 4 <= last; i += 4)
    for (int k = 0; k < 4; k++) {  // 4 symbols of at most 11 bits per reload
      br[k].reload();
      huf_symbol(H, br[k], op[k]);
      huf_symbol(H, br[k], op[k]);
      huf_symbol(H, br[k], op[k]);
      huf_symbol(H, br[k], op[k]);
    }
  for (int k = 0; k < 4; k++) huf_tail(H, br[k], op[k], out + k * seg + (k < 3 ? seg : last));
}

// ---------------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// One frame's decoding state: what a block may repeat from an earlier one.
struct Frame {
  uint8_t lit[kBlockMax];
  HufTable huf;
  bool hufValid = false;
  FseTable ll, of, ml;
  bool llValid = false, ofValid = false, mlValid = false;
  uint64_t rep[3] = {1, 4, 8};
};

size_t read_table(int mode, const uint8_t* src, size_t n, FseTable& T, bool& valid,
                  const int16_t* def, int defMax, int defLog, int maxSym, int maxLog) {
  switch (mode) {
    case 0:
      fse_build(T, def, defMax, defLog);
      valid = true;
      return 0;
    case 1:
      if (n < 1) fail(E_TRUNCATED);
      if (src[0] > maxSym) fail(E_CORRUPT);
      fse_rle(T, src[0]);
      valid = true;
      return 1;
    case 2: {
      int16_t norm[64];
      int ms = maxSym, log;
      const size_t used = read_ncount(src, n, norm, ms, log, maxLog);
      fse_build(T, norm, ms, log);
      valid = true;
      return used;
    }
    default:
      if (!valid) fail(E_CORRUPT);
      return 0;
  }
}

// Decode one compressed block of `n` bytes; returns the new output end.
uint8_t* decode_block(Frame& F, const uint8_t* src, size_t n, uint8_t* const frameStart,
                      uint8_t* op, uint8_t* const oend) {
  const uint8_t* const iend = src + n;
  // literals section
  if (n < 1) fail(E_TRUNCATED);
  const int ltype = src[0] & 3, sf = (src[0] >> 2) & 3;
  const uint8_t* lit;
  size_t litSize;
  const uint8_t* ip;
  if (ltype <= 1) {  // raw or RLE
    size_t hs;
    if (sf == 1) {
      hs = 2;
      if (n < hs) fail(E_TRUNCATED);
      litSize = (src[0] >> 4) | (size_t(src[1]) << 4);
    } else if (sf == 3) {
      hs = 3;
      if (n < hs) fail(E_TRUNCATED);
      litSize = (src[0] >> 4) | (size_t(src[1]) << 4) | (size_t(src[2]) << 12);
    } else {
      hs = 1;
      litSize = src[0] >> 3;
    }
    if (litSize > kBlockMax) fail(E_CORRUPT);
    if (ltype == 0) {
      if (n - hs < litSize) fail(E_TRUNCATED);
      lit = src + hs;
      ip = src + hs + litSize;
    } else {
      if (n - hs < 1) fail(E_TRUNCATED);
      std::memset(F.lit, src[hs], litSize);
      lit = F.lit;
      ip = src + hs + 1;
    }
  } else {  // Huffman-coded, with a new tree (2) or the previous one (3)
    size_t hs, csize;
    if (sf <= 1) {
      hs = 3;
      if (n < hs) fail(E_TRUNCATED);
      const uint32_t h = rd24(src);
      litSize = (h >> 4) & 0x3FF;
      csize = (h >> 14) & 0x3FF;
    } else if (sf == 2) {
      hs = 4;
      if (n < hs) fail(E_TRUNCATED);
      const uint32_t h = rd32(src);
      litSize = (h >> 4) & 0x3FFF;
      csize = h >> 18;
    } else {
      hs = 5;
      if (n < hs) fail(E_TRUNCATED);
      const uint64_t h = rd32(src) | (uint64_t(src[4]) << 32);
      litSize = (h >> 4) & 0x3FFFF;
      csize = (h >> 22) & 0x3FFFF;
    }
    if (litSize > kBlockMax) fail(E_CORRUPT);
    if (n - hs < csize) fail(E_TRUNCATED);
    const uint8_t* p = src + hs;
    size_t rem = csize;
    if (ltype == 2) {
      const size_t t = huf_read(p, rem, F.huf);
      p += t;
      rem -= t;
      F.hufValid = true;
    } else if (!F.hufValid) {
      fail(E_CORRUPT);
    }
    if (sf == 0) {
      huf_stream(F.huf, p, rem, F.lit, litSize);
    } else {
      if (rem < 6) fail(E_CORRUPT);
      const size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
      if (s1 + s2 + s3 > rem - 6) fail(E_CORRUPT);
      const size_t s4 = rem - 6 - s1 - s2 - s3, seg = (litSize + 3) / 4;
      if (3 * seg > litSize) fail(E_CORRUPT);
      const uint8_t* q[4] = {p + 6, p + 6 + s1, p + 6 + s1 + s2, p + 6 + s1 + s2 + s3};
      const size_t sizes[4] = {s1, s2, s3, s4};
      huf_streams4(F.huf, q, sizes, F.lit, seg, litSize - 3 * seg);
    }
    lit = F.lit;
    ip = src + hs + csize;
  }
  const uint8_t* litEnd = lit + litSize;

  // sequences section
  if (ip >= iend) fail(E_TRUNCATED);
  size_t nbSeq = *ip++;
  if (nbSeq >= 128) {
    if (nbSeq == 255) {
      if (iend - ip < 2) fail(E_TRUNCATED);
      nbSeq = rd16(ip) + 0x7F00;
      ip += 2;
    } else {
      if (iend - ip < 1) fail(E_TRUNCATED);
      nbSeq = ((nbSeq - 128) << 8) + *ip++;
    }
  }
  if (nbSeq == 0) {
    if (ip != iend) fail(E_CORRUPT);
  } else {
    if (ip >= iend) fail(E_TRUNCATED);
    const uint8_t modes = *ip++;
    if (modes & 3) fail(E_RESERVED);
    ip += read_table(modes >> 6, ip, iend - ip, F.ll, F.llValid, kLLDefault, 35, 6, 35, 9);
    ip += read_table((modes >> 4) & 3, ip, iend - ip, F.of, F.ofValid, kOFDefault, 28, 5, 31, 8);
    ip += read_table((modes >> 2) & 3, ip, iend - ip, F.ml, F.mlValid, kMLDefault, 52, 6, 52, 9);
    if (ip > iend) fail(E_TRUNCATED);
    BackBits br;
    br.init(ip, iend - ip);
    unsigned sLL = unsigned(br.read(F.ll.log));
    unsigned sOF = unsigned(br.read(F.of.log));
    unsigned sML = unsigned(br.read(F.ml.log));
    br.reload();
    uint64_t* rep = F.rep;
    for (size_t i = 0; i < nbSeq; i++) {
      const unsigned ofCode = F.of.t[sOF].symbol, mlCode = F.ml.t[sML].symbol,
                     llCode = F.ll.t[sLL].symbol;
      uint64_t ofv = (uint64_t(1) << ofCode) + br.read(ofCode);
      br.reload();
      const size_t ml = kMLBase[mlCode] + size_t(br.read(kMLBits[mlCode]));
      const size_t ll = kLLBase[llCode] + size_t(br.read(kLLBits[llCode]));
      br.reload();
      uint64_t off;
      if (ofv > 3) {
        off = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = off;
      } else {
        const unsigned idx = unsigned(ofv) - 1 + (ll == 0);
        if (idx == 0) {
          off = rep[0];
        } else {
          off = idx == 3 ? rep[0] - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = off;
        }
      }
      if (i + 1 < nbSeq) {
        fse_decode(F.ll, sLL, br);
        fse_decode(F.ml, sML, br);
        fse_decode(F.of, sOF, br);
        br.reload();
      }
      // execute: literals, then the match
      if (ll > size_t(litEnd - lit)) fail(E_CORRUPT);
      if (ll + ml > size_t(oend - op)) fail(E_DST_SIZE);
      std::memcpy(op, lit, ll);
      op += ll;
      lit += ll;
      if (off == 0 || off > uint64_t(op - frameStart)) fail(E_CORRUPT);
      const uint8_t* m = op - off;
      uint8_t* const mend = op + ml;
      if (off >= ml) {
        std::memcpy(op, m, ml);
        op = mend;
      } else {  // the match overlaps itself: copy whole periods, doubling
        while (op < mend) {
          size_t k = size_t(op - m);
          if (k > size_t(mend - op)) k = size_t(mend - op);
          std::memcpy(op, m, k);
          op += k;
        }
      }
    }
    if (br.remaining() != 0) fail(E_CORRUPT);
  }
  const size_t rest = size_t(litEnd - lit);
  if (rest > size_t(oend - op)) fail(E_DST_SIZE);
  std::memcpy(op, lit, rest);
  return op + rest;
}

// ---------------------------------------------------------------- frames

struct Header {
  size_t size;             // header bytes after the magic number
  bool hasFcs, checksum;
  uint64_t fcs;
};

Header read_header(const uint8_t* p, size_t n) {  // p: after the magic
  if (n < 1) fail(E_TRUNCATED);
  const uint8_t d = p[0];
  if (d & 0x08) fail(E_RESERVED);
  const int fcsFlag = d >> 6, didFlag = d & 3;
  const bool single = (d >> 5) & 1;
  const size_t didSize = didFlag == 3 ? 4 : didFlag;
  const size_t fcsSize = fcsFlag == 0 ? (single ? 1 : 0) : (size_t(1) << fcsFlag);
  Header h{1 + (single ? 0 : 1) + didSize + fcsSize, fcsSize > 0, bool(d & 4), 0};
  if (n < h.size) fail(E_TRUNCATED);
  const uint8_t* q = p + 1 + (single ? 0 : 1);
  uint32_t did = 0;
  for (size_t i = 0; i < didSize; i++) did |= uint32_t(q[i]) << (8 * i);
  if (did) fail(E_DICTIONARY);
  q += didSize;
  for (size_t i = 0; i < fcsSize; i++) h.fcs |= uint64_t(q[i]) << (8 * i);
  if (fcsSize == 2) h.fcs += 256;
  return h;
}

// Walks one frame's block headers; returns the frame's bytes and adds an
// upper bound of its output to `bound`.
size_t walk_frame(const uint8_t* p, size_t n, const Header& h, uint64_t& bound) {
  size_t pos = 4 + h.size;
  uint64_t b = 0;
  while (true) {
    if (n - pos < 3) fail(E_TRUNCATED);
    const uint32_t bh = rd24(p + pos);
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    pos += 3;
    if (type == 3) fail(E_RESERVED);
    const size_t take = type == 1 ? 1 : size;
    if (n - pos < take) fail(E_TRUNCATED);
    pos += take;
    b += type == 2 ? kBlockMax : size;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (n - pos < 4) fail(E_TRUNCATED);
    pos += 4;
  }
  bound += h.hasFcs ? h.fcs : b;
  return pos;
}

// ---------------------------------------------------------------- xxh64

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* const end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* const limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// Decodes the frame at p (magic included) into [op, oend); returns the
// frame's bytes and advances op.
size_t decode_frame(Frame& F, const uint8_t* p, size_t n, uint8_t*& op, uint8_t* const oend) {
  const Header h = read_header(p + 4, n - 4);
  if (h.hasFcs && h.fcs > uint64_t(oend - op)) fail(E_DST_SIZE);
  new (&F) Frame();
  uint8_t* const frameStart = op;
  size_t pos = 4 + h.size;
  while (true) {
    if (n - pos < 3) fail(E_TRUNCATED);
    const uint32_t bh = rd24(p + pos);
    const int type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    pos += 3;
    if (type == 0) {
      if (n - pos < size) fail(E_TRUNCATED);
      if (size > size_t(oend - op)) fail(E_DST_SIZE);
      std::memcpy(op, p + pos, size);
      op += size;
      pos += size;
    } else if (type == 1) {
      if (n - pos < 1) fail(E_TRUNCATED);
      if (size > size_t(oend - op)) fail(E_DST_SIZE);
      std::memset(op, p[pos], size);
      op += size;
      pos += 1;
    } else if (type == 2) {
      if (n - pos < size) fail(E_TRUNCATED);
      if (size > kBlockMax) fail(E_CORRUPT);
      uint8_t* const blockStart = op;
      op = decode_block(F, p + pos, size, frameStart, op, oend);
      if (size_t(op - blockStart) > kBlockMax) fail(E_CORRUPT);
      pos += size;
    } else {
      fail(E_RESERVED);
    }
    if (bh & 1) break;
  }
  const size_t produced = size_t(op - frameStart);
  if (h.checksum) {
    if (n - pos < 4) fail(E_TRUNCATED);
    if (uint32_t(xxh64(frameStart, produced)) != rd32(p + pos)) fail(E_CHECKSUM);
    pos += 4;
  }
  if (h.hasFcs && produced != h.fcs) fail(E_CONTENT_SIZE);
  return pos;
}

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

size_t skip_frame(const uint8_t* p, size_t n) {
  if (n < 8) fail(E_TRUNCATED);
  const size_t size = rd32(p + 4);
  if (n - 8 < size) fail(E_TRUNCATED);
  return 8 + size;
}

// Walks every frame; returns the declared total (or E_UNKNOWN) and sets
// `bound`.
int64_t scan(const uint8_t* src, size_t n, uint64_t& bound) {
  if (n == 0) fail(E_TRUNCATED);
  bool known = true;
  uint64_t total = 0;
  bound = 0;
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 4) fail(E_TRUNCATED);
    const uint32_t magic = rd32(src + pos);
    if (skippable(magic)) {
      pos += skip_frame(src + pos, n - pos);
      continue;
    }
    if (magic != kMagic) fail(E_MAGIC);
    const Header h = read_header(src + pos + 4, n - pos - 4);
    known = known && h.hasFcs;
    total += h.fcs;
    pos += walk_frame(src + pos, n - pos, h, bound);
  }
  if (bound > (uint64_t(1) << 62)) fail(E_CORRUPT);
  return known ? int64_t(total) : E_UNKNOWN;
}

uint32_t crc_table[8][256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
      crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int t = 1; t < 8; t++)
        crc_table[t][i] = (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  }
} crc_init;

}  // namespace

extern "C" {

int64_t rp_zstd_content_size(const uint8_t* src, int64_t n) {
  try {
    if (n < 0) return E_TRUNCATED;
    uint64_t bound;
    return scan(src, size_t(n), bound);
  } catch (const Fail& f) {
    return f.code;
  }
}

int64_t rp_zstd_decompress_bound(const uint8_t* src, int64_t n) {
  try {
    if (n < 0) return E_TRUNCATED;
    uint64_t bound;
    scan(src, size_t(n), bound);
    return int64_t(bound);
  } catch (const Fail& f) {
    return f.code;
  }
}

int64_t rp_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  if (n <= 0) return E_TRUNCATED;
  if (cap < 0) return E_DST_SIZE;
  Frame* F = static_cast<Frame*>(::operator new(sizeof(Frame), std::nothrow));
  if (!F) return E_MEMORY;
  int64_t result;
  try {
    uint8_t* op = dst;
    uint8_t* const oend = dst + cap;
    size_t pos = 0;
    while (pos < size_t(n)) {
      if (size_t(n) - pos < 4) fail(E_TRUNCATED);
      const uint32_t magic = rd32(src + pos);
      if (skippable(magic))
        pos += skip_frame(src + pos, size_t(n) - pos);
      else if (magic == kMagic)
        pos += decode_frame(*F, src + pos, size_t(n) - pos, op, oend);
      else
        fail(E_MAGIC);
    }
    result = int64_t(op - dst);
  } catch (const Fail& f) {
    result = f.code;
  }
  ::operator delete(F);
  return result;
}

uint32_t rp_crc32c(const uint8_t* src, int64_t n) {
  uint32_t c = 0xFFFFFFFFu;
  const uint8_t* p = src;
  const uint8_t* const end = src + (n > 0 ? n : 0);
  for (; end - p >= 8; p += 8) {
    const uint32_t a = rd32(p) ^ c, b = rd32(p + 4);
    c = crc_table[7][a & 0xFF] ^ crc_table[6][(a >> 8) & 0xFF] ^ crc_table[5][(a >> 16) & 0xFF] ^
        crc_table[4][a >> 24] ^ crc_table[3][b & 0xFF] ^ crc_table[2][(b >> 8) & 0xFF] ^
        crc_table[1][(b >> 16) & 0xFF] ^ crc_table[0][b >> 24];
  }
  for (; p < end; p++) c = (c >> 8) ^ crc_table[0][(c ^ *p) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
