// HT cleanup-pass decoder for a group of same-size code-blocks, on their
// raw segment bytes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of grokimagecompression_tpu/ops/
// ht_dec_pallas.py (_pallas_group_decoder, pallas_call at :490, reached
// through decode_group_pallas :534) together with the host prepass that
// feeds it (ht_dec_jax.py _prepass_mel :293, _prepass_vlc :315,
// _prepass_ms :274, prepass_all :345; the port's csrc/host/ht_prepass.cpp).
// It computes what the prepass followed by ht_dec_jax.decode_group_core
// computes, bit for bit, and what ops/ht_dec_torch.decode_group_plain
// spells out step by step on the prepass's words.
//
// One code-block is one lane. A lane walks the T = ceil(w/4) * ceil(h/2)
// steps of its block row-pair-major, two quads a step: CxtVLC decode of
// each quad through a 1024-entry LUT, the MEL run decoder for
// all-zero-context quads, the UVLC code of the pair, then the eight
// MagSgn samples. Every step depends on the one before through the three
// stream positions, so the kernel is bound by the latency of that chain,
// not by bytes or operations. The design:
//   - three stream readers in registers, one per stream, each with a
//     64-bit window of unstuffed bits that it refills from the lane's raw
//     bytes (MEL and MagSgn forward, VLC backward) whenever fewer than 32
//     bits are left, so every fetch of the decoder (at most 32 bits)
//     reads registers. MagSgn and VLC take four bytes at once when none
//     of them is stuffed (one SIMD byte compare), else byte by byte. A
//     reader's bytes come from aligned 4-byte words loaded two words
//     ahead of need, so the chain waits on no load;
//   - each reader unstuffs as the prepass does, including its one quirk:
//     a stuffed byte (7 payload bits) is still ORed in whole, so its top
//     bit overlaps the first bit of the byte after it (MEL: the last bit
//     of the byte before). Past its stream's end a reader takes pad bytes:
//     0xFF for MEL and MagSgn, 0x00 for VLC;
//   - the line state (significance and exponent of the row above, qw + 4
//     entries a lane) and the two decode LUTs (8 KB) live in shared memory;
//   - a quad's MagSgn samples are cut from the window at once when it
//     holds all of their bits (their offsets are prefix sums of lengths
//     known from the quad's flags and U_p), so the window moves once a
//     quad;
//   - magnitudes and signs go straight to the (B, 2*ny, 4*nx) grid;
//   - lanes run in the wrapper's order (longest segment first), so the
//     lanes of a warp end together;
//   - two threads a lane (kSplit), the lanes' first threads in one warp
//     and their second threads in another: the first runs the CxtVLC /
//     MEL / UVLC chain (its line state keeps significance only) and
//     hands each step's two quad flag words and u values to the second
//     through a ring of kRing steps in shared memory; the second runs the
//     MagSgn chain, whose offsets depend only on those, with the exponent
//     line state. 32 lanes a block and two threads a lane won the trial
//     that chip_smoke.py runs (32 / 16 / 8 lanes, one or two threads) on
//     every config-1 lane group and a config-2 one; with fewer lanes the
//     two roles share a warp and lose. kSplit = false is the one-thread
//     form the trial builds.
// Offsets into the segment bytes are int64. Magnitudes are the centred
// (v+2)>>1 form in uint32 arithmetic, so they stay below 2^31 and leave
// as int32.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;       // lanes a block
constexpr bool kSplit = true;    // two threads a lane (see above)
constexpr int kRing = 32;        // steps in flight between the two threads
constexpr long long kSpinLimit = 1ll << 26;   // ring waits before giving up

__device__ __forceinline__ uint64_t shr64(uint64_t x, int c) {
  return c >= 64 ? 0ull : x >> c;
}

// The bytes of one stream of a lane, in stream order: forward from `p`
// (MEL, MagSgn) or backward from `p` (VLC), n of them, then `pad`
// forever. `raw` holds the next 4 to 8 bytes, the next one lowest; the
// two aligned words after them wait in q0 and q1, loaded two words ahead
// of need.
template <bool kBack>
struct Bytes {
  const uint32_t* wp;   // aligned word holding the stream's first byte
  uint64_t raw;
  uint32_t q0, q1;
  int nraw, wi, nw, left;
  uint32_t pad;

  // word k of the stream's words (k words after the first one, in stream
  // order), bytes in stream order; 0 past the stream's words
  __device__ __forceinline__ uint32_t load(int k) const {
    if (k >= nw) return 0u;
    if (kBack) return __byte_perm(__ldg(wp - k), 0, 0x0123);
    return __ldg(wp + k);
  }
  __device__ __forceinline__ void init(const uint8_t* p, int n, uint32_t pd) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    wp = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    const int j = static_cast<int>(a & 3);   // p's byte in its word
    // bytes of word 0 before the stream's first one, in stream order
    const int skip = kBack ? 3 - j : j;
    nw = 0;
    if (n > 0)
      nw = kBack ? static_cast<int>((a >> 2) - ((a - n + 1) >> 2)) + 1
                 : (j + n + 3) >> 2;
    left = n;
    pad = pd;
    raw = static_cast<uint64_t>(load(0)) >> (8 * skip);
    nraw = 4 - skip;
    raw |= static_cast<uint64_t>(load(1)) << (8 * nraw);
    nraw += 4;
    q0 = load(2);
    q1 = load(3);
    wi = 3;
  }
  __device__ __forceinline__ void advance() {   // after nraw fell below 4
    raw |= static_cast<uint64_t>(q0) << (8 * nraw);
    nraw += 4;
    q0 = q1;
    q1 = load(++wi);
  }
  // the next byte, or `pad` past the stream
  __device__ __forceinline__ uint32_t take() {
    if (left <= 0) return pad;
    const uint32_t d = static_cast<uint32_t>(raw) & 0xFFu;
    raw >>= 8;
    --left;
    if (--nraw < 4) advance();
    return d;
  }
  // the next four bytes, the first lowest (only while left >= 4)
  __device__ __forceinline__ uint32_t peek4() const {
    return static_cast<uint32_t>(raw);
  }
  __device__ __forceinline__ void take4() {
    raw >>= 32;
    left -= 4;
    nraw -= 4;
    advance();
  }
};

// MagSgn: forward, LSB first; a byte after 0xFF carries 7 bits; pad 0xFF.
// Whenever fewer than 32 bits are left it refills: four plain bytes at
// once, else byte by byte.
struct MsReader {
  Bytes<false> src;
  uint64_t win;     // stream bits from the read position up, bit 0 first
  int nbits;        // valid bits in win (one more may sit above them)
  bool unstuff;
  __device__ __forceinline__ void fill() {
    if (nbits >= 32) return;
    if (src.left >= 4 && !unstuff && __vcmpeq4(src.peek4(), ~0u) == 0) {
      win |= static_cast<uint64_t>(src.peek4()) << nbits;
      nbits += 32;
      src.take4();
      return;
    }
    if (src.left <= 0) {   // the pad: all 1-bits
      win |= ~0ull << nbits;
      nbits = 64;
      return;
    }
    while (nbits < 32) {
      const uint32_t d = src.take();
      win |= static_cast<uint64_t>(d) << nbits;
      nbits += unstuff ? 7 : 8;
      unstuff = d == 0xFFu;
    }
  }
  __device__ __forceinline__ void init(const uint8_t* seg, int n) {
    src.init(seg, n, 0xFFu);
    win = 0;
    nbits = 0;
    unstuff = false;
    fill();
  }
  __device__ __forceinline__ uint32_t peek() const {
    return static_cast<uint32_t>(win);
  }
  __device__ __forceinline__ void skip(uint32_t c) {
    while (c > static_cast<uint32_t>(nbits)) {   // only on corrupt streams
      c -= nbits;
      win = shr64(win, nbits);
      nbits = 0;
      fill();
    }
    win = shr64(win, static_cast<int>(c));
    nbits -= static_cast<int>(c);
    fill();
  }
};

// VLC: backward from byte lcup - 3 after the high nibble of byte lcup - 2
// (3 bits when its low 3 bits are 111), LSB first; a byte whose low 7
// bits are all 1 carries 7 bits when the byte before it was above 0x8F;
// pad 0x00. Refills as MsReader does.
struct VlcReader {
  Bytes<true> src;
  uint64_t win;
  int nbits;
  bool unstuff;
  __device__ __forceinline__ void fill() {
    if (nbits >= 32) return;
    const uint32_t x = src.peek4();
    if (src.left >= 4 && __vcmpeq4(x & 0x7F7F7F7Fu, 0x7F7F7F7Fu) == 0) {
      win |= static_cast<uint64_t>(x) << nbits;
      nbits += 32;
      unstuff = (x >> 24) > 0x8Fu;
      src.take4();
      return;
    }
    if (src.left <= 0) {   // the pad: 0-bits
      nbits = 64;
      return;
    }
    while (nbits < 32) {
      const uint32_t d = src.take();
      win |= static_cast<uint64_t>(d) << nbits;
      nbits += (unstuff && (d & 0x7Fu) == 0x7Fu) ? 7 : 8;
      unstuff = d > 0x8Fu;
    }
  }
  __device__ __forceinline__ void init(const uint8_t* seg, int lcup,
                                       int scup) {
    const uint32_t d0 = __ldg(seg + lcup - 2);
    win = d0 >> 4;
    nbits = 4 - ((win & 7u) == 7u ? 1 : 0);
    unstuff = (d0 | 0xFu) > 0x8Fu;
    src.init(seg + lcup - 3, scup - 2, 0u);
    fill();
  }
  __device__ __forceinline__ uint32_t peek() const {
    return static_cast<uint32_t>(win);
  }
  __device__ __forceinline__ void skip(int c) {   // c <= 32
    win >>= c;
    nbits -= c;
    fill();
  }
};

// MEL: forward from byte lcup - scup over scup - 1 bytes, the last with
// its low nibble forced to 0xF, MSB first; a byte after 0xFF carries 7
// bits (its top bit overlaps the last bit of the 0xFF); pad 0xFF. Refills
// byte by byte to 57-64 bits whenever fewer than 32 are left.
struct MelReader {
  Bytes<false> src;
  uint64_t win;     // stream bits from the read position on, bit 63 first
  int nbits;
  bool unstuff;
  __device__ __forceinline__ void fill() {
    if (nbits >= 32) return;
    while (nbits <= 56) {
      const bool last = src.left == 1;
      uint32_t d = src.take();
      if (last) d |= 0xFu;
      // the byte's first bit at stream position s (s = -1: on a bit
      // already read, which is 1, so it drops out)
      const int s = unstuff ? nbits - 1 : nbits;
      win |= static_cast<uint64_t>(d) << (56 - s);
      nbits += unstuff ? 7 : 8;
      unstuff = d == 0xFFu;
    }
  }
  __device__ __forceinline__ void init(const uint8_t* seg, int n) {
    src.init(seg, n, 0xFFu);
    win = 0;
    nbits = 0;
    unstuff = false;
    fill();
  }
  __device__ __forceinline__ uint32_t peek() const {
    return static_cast<uint32_t>(win >> 32);
  }
  __device__ __forceinline__ void skip(int c) {   // c <= 6
    win <<= c;
    nbits -= c;
    fill();
  }
};

__device__ __forceinline__ int mel_exp(int k) {
  return k < 3 ? 0 : k < 6 ? 1 : k < 9 ? 2 : k < 11 ? 3 : k < 12 ? 4 : 5;
}

// one MEL run: updates run and k
__device__ __forceinline__ void mel_get_run(MelReader& mel, int& run,
                                            int& k) {
  const uint32_t win = mel.peek();
  const int e = mel_exp(k);
  if (win >> 31) {
    run = ((1 << e) - 1) << 1;
    k = min(k + 1, 12);
    mel.skip(1);
  } else {
    const uint32_t rest = e > 0 ? (win << 1) >> (32 - e) : 0u;
    run = (static_cast<int>(rest) << 1) + 1;
    k = max(k - 1, 0);
    mel.skip(e + 1);
  }
}

__device__ __forceinline__ void uvlc_classify(uint32_t win, int& pre,
                                              int& suf, int& base) {
  if (win & 1) {
    pre = 1; suf = 0; base = 1;
  } else if ((win & 3) == 2) {
    pre = 2; suf = 0; base = 2;
  } else if ((win & 7) == 4) {
    pre = 3; suf = 1; base = 3;
  } else {
    pre = 3; suf = 5; base = 5;
  }
}

__device__ __forceinline__ uint32_t low_bits(uint32_t v, int n) {
  return v & ((1u << n) - 1u);   // n <= 5
}

// UVLC code of a quad pair: u0, u1 and the bits consumed
__device__ __forceinline__ void uvlc_decode(uint32_t win, int mode,
                                            bool initial, int& u0, int& u1,
                                            int& c) {
  u0 = 0; u1 = 0; c = 0;
  if (mode == 0) return;
  int p1, s1, b1;
  uvlc_classify(win, p1, s1, b1);
  const uint32_t wa = win >> p1;
  if (mode <= 2) {
    const int v = b1 + static_cast<int>(low_bits(wa, s1));
    if (mode == 1) u0 = v; else u1 = v;
    c = p1 + s1;
    return;
  }
  if (initial && mode == 3 && p1 > 2) {
    // a long u0 prefix leaves one bit for u1 in {1, 2}
    u1 = static_cast<int>(wa & 1) + 1;
    u0 = b1 + static_cast<int>(low_bits(wa >> 1, s1));
    c = p1 + 1 + s1;
    return;
  }
  int p2, s2, b2;
  uvlc_classify(wa, p2, s2, b2);
  const uint32_t wb = wa >> p2;
  u0 = b1 + static_cast<int>(low_bits(wb, s1));
  u1 = b2 + static_cast<int>(low_bits(wb >> s1, s2));
  c = p1 + p2 + s1 + s2;
  if (initial && mode >= 4) {
    u0 += 2;
    u1 += 2;
  }
}

__device__ __forceinline__ int bit_length(uint32_t v) {
  return v ? 32 - __clz(v) : 0;
}

// One quad's four samples (n = 2*col + row) written to the lane's grid at
// (y0, x0), two samples of a row in one 8-byte store; returns the
// bottom-left / bottom-right significance and exponents for the line
// state. Sample n takes m_n = U_p - (its exponent bit) MagSgn bits when it
// is significant; the offsets of the four are prefix sums of those, so
// when the window holds all of them the samples are cut from it
// independently and the window moves once (the same bits the sequential
// walk reads: a refill only appends bits above the window's end).
__device__ __forceinline__ void decode_quad(
    MsReader& ms, int qf, int U_p, int32_t* __restrict__ mags,
    int32_t* __restrict__ signs, int W4, int y0, int x0, bool& bl_s,
    int& bl_e, bool& br_s, int& br_e) {
  uint32_t m[4], v[4], mag[4], sign[4];
  uint32_t total = 0;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    m[n] = (qf >> (4 + n)) & 1
               ? static_cast<uint32_t>(U_p - ((qf >> (12 + n)) & 1))
               : 0u;
    total += m[n];
  }
  const bool one_window = total <= static_cast<uint32_t>(ms.nbits);
  uint32_t off = 0;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    v[n] = 0u;
    mag[n] = 0u;
    sign[n] = 0u;
    if ((qf >> (4 + n)) & 1) {
      const uint32_t win = one_window
                               ? static_cast<uint32_t>(ms.win >> off)
                               : ms.peek();
      const uint32_t m_n = m[n];
      const uint32_t mask = m_n < 32 ? (1u << m_n) - 1u : 0xFFFFFFFFu;
      v[n] = (win & mask) | (static_cast<uint32_t>((qf >> (8 + n)) & 1)
                             << (m_n & 31)) | 1u;
      if (one_window)
        off += m_n;
      else
        ms.skip(m_n);
      mag[n] = (v[n] + 2u) >> 1;
      sign[n] = win & 1u;
    }
  }
  if (one_window) ms.skip(total);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = static_cast<size_t>(y0 + r) * W4 + x0;
    *reinterpret_cast<int2*>(mags + at) =
        make_int2(static_cast<int>(mag[r]), static_cast<int>(mag[2 + r]));
    *reinterpret_cast<int2*>(signs + at) =
        make_int2(static_cast<int>(sign[r]), static_cast<int>(sign[2 + r]));
  }
  bl_s = (qf >> 5) & 1;
  bl_e = bit_length(v[1]);
  br_s = (qf >> 7) & 1;
  br_e = bit_length(v[3]);
}

__device__ __forceinline__ int c_p_of(int qf, bool row0) {
  return row0 ? ((qf & 0x10) >> 4) | ((qf & 0xE0) >> 5)
              : ((qf & 0x40) >> 5) | ((qf & 0x80) >> 6);
}

// The line state of one lane: entry i at ls[i * stride] (bit 7
// significance, bits 0-6 exponent of the row above).
struct LineState {
  int32_t* p;
  int stride;
  __device__ __forceinline__ int32_t& operator[](int i) const {
    return p[i * stride];
  }
  // the entries the two quads of step x write: quad 0's bottom-left and
  // bottom-right, quad 1's (present when has_q1)
  __device__ __forceinline__ void update(int q, bool has_q1, bool bl_s0,
                                         int bl_e0, bool br_s0, int br_e0,
                                         bool bl_s1, int bl_e1, bool br_s1,
                                         int br_e1) const {
    LineState L = *this;
    const int ent_q = L[q];
    if (bl_s0) L[q] = (ent_q & 0x80) | 0x80 | max(ent_q & 0x7F, bl_e0);
    int e_q1 = br_s0 ? 0x80 | br_e0 : 0;
    if (bl_s1) e_q1 = (e_q1 & 0x80) | 0x80 | max(e_q1 & 0x7F, bl_e1);
    L[q + 1] = e_q1;
    L[q + 2] = (br_s1 && has_q1) ? 0x80 | br_e1 : 0;
  }
};

// The CxtVLC / MEL / UVLC chain of one step: the two quads' flag words
// and u values. `ls_q1`, `ls_q2` and `ls0` are the line state the
// context reads (significance only).
struct VlcChain {
  VlcReader vlc;
  MelReader mel;
  int mel_run, mel_k, c_p;
  __device__ __forceinline__ void init(const uint8_t* seg, int lcup,
                                       int scup) {
    vlc.init(seg, lcup, scup);
    mel.init(seg + (lcup - scup), scup - 1);
    mel_run = 0;
    mel_k = 0;
    mel_get_run(mel, mel_run, mel_k);
  }
  __device__ __forceinline__ int quad(const int32_t* dec, bool row0,
                                      int ctx_ls) {
    const int cq = row0 ? c_p : c_p | ctx_ls;
    int qf = dec[(cq << 7) | (vlc.peek() & 0x7F)];
    if (cq == 0) {
      mel_run -= 2;
      if (mel_run != -1) qf = 0;
      if (mel_run < 0) mel_get_run(mel, mel_run, mel_k);
    }
    c_p = c_p_of(qf, row0);
    vlc.skip(qf & 0x7);
    return qf;
  }
  __device__ __forceinline__ void step(const int32_t* dec, bool row0,
                                       bool has_q1, int ls0, int ls_q1,
                                       int ls_q2, int& qf0, int& qf1,
                                       int& u0, int& u1) {
    qf0 = quad(dec, row0, (ls0 >> 7) | ((ls_q1 >> 5) & 4));
    qf1 = has_q1 ? quad(dec, row0, (ls_q1 >> 7) | ((ls_q2 >> 5) & 4)) : 0;
    int mode = ((qf0 & 0x8) >> 3) | ((qf1 & 0x8) >> 2);
    if (row0 && mode == 3) {
      mel_run -= 2;
      if (mel_run == -1) mode += 1;
      if (mel_run < 0) mel_get_run(mel, mel_run, mel_k);
    }
    int c_u;
    uvlc_decode(vlc.peek(), mode, row0, u0, u1, c_u);
    vlc.skip(c_u);
  }
};

// The MagSgn chain of one step, from the VLC chain's flag words and u
// values: U_p with the exponent bonus of the row above, the eight
// samples, the line-state writes.
__device__ __forceinline__ void ms_step(MsReader& ms, const LineState& L,
                                        bool row0, bool has_q1, int q, int x,
                                        int iy, int& ls0, int qf0, int qf1,
                                        int u0, int u1, int32_t* gm,
                                        int32_t* gs, int W4) {
  const int ls_q1 = L[q + 1], ls_q2 = L[q + 2];
  int U_p0 = u0 + 1, U_p1 = u1 + 1;
  if (!row0) {
    // exponent bonus for quads with 2+ significant samples
    const int s0 = qf0 & 0xF0, s1 = qf1 & 0xF0;
    const int e0 = max(ls0 & 0x7F, ls_q1 & 0x7F) - 2;
    const int e1 = max(ls_q1 & 0x7F, ls_q2 & 0x7F) - 2;
    if (s0 & (s0 - 1)) U_p0 += max(e0, 0);
    if (s1 & (s1 - 1)) U_p1 += max(e1, 0);
    ls0 = ls_q2;
  }
  bool bl_s0, br_s0, bl_s1, br_s1;
  int bl_e0, br_e0, bl_e1, br_e1;
  decode_quad(ms, qf0, U_p0, gm, gs, W4, 2 * iy, x, bl_s0, bl_e0, br_s0,
              br_e0);
  decode_quad(ms, qf1, U_p1, gm, gs, W4, 2 * iy, x + 2, bl_s1, bl_e1, br_s1,
              br_e1);
  L.update(q, has_q1, bl_s0, bl_e0, br_s0, br_e0, bl_s1, bl_e1, br_s1,
           br_e1);
}

struct Geometry {
  int w, nx, ny, W4;
};

// One lane on one thread: both chains interleaved, step by step.
__device__ void decode_lane(const uint8_t* seg, int lcup, int scup,
                            const int32_t* dec0, const int32_t* dec1,
                            const LineState& L, const Geometry& g,
                            int32_t* gm, int32_t* gs) {
  VlcChain vc;
  vc.init(seg, lcup, scup);
  MsReader ms;
  ms.init(seg, lcup - scup);
  int ls0 = 0;
  for (int iy = 0; iy < g.ny; ++iy) {
    const bool row0 = iy == 0;
    const int32_t* dec = row0 ? dec0 : dec1;
    ls0 = L[0];
    L[0] = 0;
    vc.c_p = 0;
    for (int ix = 0; ix < g.nx; ++ix) {
      const int x = 4 * ix, q = x >> 1;
      const bool has_q1 = x + 2 < g.w;
      int qf0, qf1, u0, u1;
      vc.step(dec, row0, has_q1, ls0, L[q + 1], L[q + 2], qf0, qf1, u0, u1);
      ms_step(ms, L, row0, has_q1, q, x, iy, ls0, qf0, qf1, u0, u1, gm, gs,
              g.W4);
    }
  }
}

// kSplit, the first thread of a lane: the VLC chain, with a line state of
// significance bits only, handing (qf | u << 16) pairs to the ring.
// Returns false when the ring stalled past kSpinLimit.
__device__ bool vlc_lane(const uint8_t* seg, int lcup, int scup,
                         const int32_t* dec0, const int32_t* dec1,
                         const LineState& L, const Geometry& g,
                         volatile int32_t* ring, int rs,
                         volatile int32_t* made, volatile int32_t* used) {
  VlcChain vc;
  vc.init(seg, lcup, scup);
  int ls0 = 0, t = 0, seen = 0;
  for (int iy = 0; iy < g.ny; ++iy) {
    const bool row0 = iy == 0;
    const int32_t* dec = row0 ? dec0 : dec1;
    ls0 = L[0];
    L[0] = 0;
    vc.c_p = 0;
    for (int ix = 0; ix < g.nx; ++ix, ++t) {
      const int x = 4 * ix, q = x >> 1;
      const bool has_q1 = x + 2 < g.w;
      const int ls_q1 = L[q + 1], ls_q2 = L[q + 2];
      int qf0, qf1, u0, u1;
      vc.step(dec, row0, has_q1, ls0, ls_q1, ls_q2, qf0, qf1, u0, u1);
      if (!row0) ls0 = ls_q2;
      L.update(q, has_q1, (qf0 >> 5) & 1, 0, (qf0 >> 7) & 1, 0,
               (qf1 >> 5) & 1, 0, (qf1 >> 7) & 1, 0);
      for (long long spin = 0; t - seen >= kRing; ++spin) {
        if (spin > kSpinLimit) return false;
        seen = *used;
      }
      const int slot = (t % kRing) * 2 * rs;
      ring[slot] = qf0 | (u0 << 16);
      ring[slot + rs] = qf1 | (u1 << 16);
      __threadfence_block();
      *made = t + 1;
    }
  }
  return true;
}

// kSplit, the second thread of a lane: the MagSgn chain on the ring.
__device__ bool ms_lane(const uint8_t* seg, int lcup, int scup,
                        const LineState& L, const Geometry& g,
                        volatile int32_t* ring, int rs,
                        volatile int32_t* made, volatile int32_t* used,
                        int32_t* gm, int32_t* gs) {
  MsReader ms;
  ms.init(seg, lcup - scup);
  int ls0 = 0, t = 0, have = 0;
  for (int iy = 0; iy < g.ny; ++iy) {
    const bool row0 = iy == 0;
    ls0 = L[0];
    L[0] = 0;
    for (int ix = 0; ix < g.nx; ++ix, ++t) {
      const int x = 4 * ix, q = x >> 1;
      const bool has_q1 = x + 2 < g.w;
      for (long long spin = 0; have <= t; ++spin) {
        if (spin > kSpinLimit) return false;
        have = *made;
      }
      __threadfence_block();
      const int slot = (t % kRing) * 2 * rs;
      const int p0 = ring[slot], p1 = ring[slot + rs];
      __threadfence_block();
      *used = t + 1;
      ms_step(ms, L, row0, has_q1, q, x, iy, ls0, p0 & 0xFFFF,
              p1 & 0xFFFF, p0 >> 16, p1 >> 16, gm, gs, g.W4);
    }
  }
  return true;
}

__global__ void __launch_bounds__(kSplit ? 2 * kLanes : kLanes)
ht_dec_kernel(const uint8_t* __restrict__ data,
              const int64_t* __restrict__ off,
              const int32_t* __restrict__ lcups,
              const int32_t* __restrict__ scups,
              const int32_t* __restrict__ order, int B, int w, int h,
              const int32_t* __restrict__ dec0_g,
              const int32_t* __restrict__ dec1_g,
              int32_t* __restrict__ mags, int32_t* __restrict__ signs,
              int32_t* __restrict__ stalled) {
  extern __shared__ int32_t smem[];
  int32_t* dec0 = smem;
  int32_t* dec1 = smem + 1024;
  const int qw = (w + 1) / 2;
  int32_t* ls = smem + 2048;     // (qw + 4) x kLanes (x 2 when split)
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) {
    dec0[i] = dec0_g[i];
    dec1[i] = dec1_g[i];
  }
  const int lane_t = threadIdx.x % kLanes;   // the lane within the block
  const int role = threadIdx.x / kLanes;     // split: 0 VLC, 1 MagSgn
  const LineState L{ls + role * (qw + 4) * kLanes + lane_t, kLanes};
  for (int i = 0; i < qw + 4; ++i) L[i] = 0;
  int32_t* made = ls + 2 * (qw + 4) * kLanes;
  int32_t* used = made + kLanes;
  int32_t* ring = used + kLanes;   // [kRing][2][kLanes]
  if (kSplit && role == 0) {
    made[lane_t] = 0;
    used[lane_t] = 0;
  }
  __syncthreads();
  const int k = blockIdx.x * kLanes + lane_t;
  if (k >= B) return;
  const int b = order[k];

  const Geometry g{w, (w + 3) / 4, (h + 1) / 2, 4 * ((w + 3) / 4)};
  int32_t* gm = mags + static_cast<size_t>(b) * (2 * g.ny) * g.W4;
  int32_t* gs = signs + static_cast<size_t>(b) * (2 * g.ny) * g.W4;
  const uint8_t* seg = data + off[b];
  const int lcup = lcups[b], scup = scups[b];
  if (!kSplit) {
    decode_lane(seg, lcup, scup, dec0, dec1, L, g, gm, gs);
    return;
  }
  const bool ok =
      role == 0
          ? vlc_lane(seg, lcup, scup, dec0, dec1, L, g, ring + lane_t,
                     kLanes, made + lane_t, used + lane_t)
          : ms_lane(seg, lcup, scup, L, g, ring + lane_t, kLanes,
                    made + lane_t, used + lane_t, gm, gs);
  if (!ok) {   // a ring that stalled: count it for a trial, else fail
    if (stalled)
      atomicAdd(stalled, 1);
    else
      __trap();
  }
}

}  // namespace

extern "C" {

// data: (N,) uint8 segment bytes; off: (B + 1,) int64, lane b's segment
// at data[off[b]:]; lcup, scup: (B,) int32 (2 <= scup <= lcup <=
// off[b + 1] - off[b]); order: (B,) int32, a permutation of the lanes;
// dec0/dec1: (1024,) int32 LUTs; mags/signs: (B, 2*ny, 4*nx) int32
// outputs; stalled: one zeroed int32 in which a split build counts the
// lanes whose ring stalled, or null: a stall then traps, so the launch
// fails rather than return a partial decode.
int ht_dec_group(const void* data, const void* off, const void* lcup,
                 const void* scup, const void* order, int B, int w, int h,
                 const void* dec0, const void* dec1, void* mags, void* signs,
                 void* stalled, void* stream) {
  const int qw = (w + 1) / 2;
  const size_t smem =
      (2048 + static_cast<size_t>(qw + 4) * kLanes * 2 +
       (kSplit ? 2 * kLanes + static_cast<size_t>(kRing) * 2 * kLanes : 0)) *
      sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ht_dec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ht_dec_kernel<<<(B + kLanes - 1) / kLanes, kSplit ? 2 * kLanes : kLanes,
                  smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(off),
      static_cast<const int32_t*>(lcup), static_cast<const int32_t*>(scup),
      static_cast<const int32_t*>(order), B, w, h,
      static_cast<const int32_t*>(dec0), static_cast<const int32_t*>(dec1),
      static_cast<int32_t*>(mags), static_cast<int32_t*>(signs),
      static_cast<int32_t*>(stalled));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
