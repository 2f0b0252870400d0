// HTJ2K (ISO/IEC 15444-15) block coder of the port's host library: the
// cleanup-pass encoder and decoder, the SigProp / MagRef refinement passes
// (Part 15 "full" mode) and the decode prepass of the CUDA HT decoder's
// plain version. A copy of grokimagecompression_tpu/native/src/ht.cpp: the
// coder (its (mag, neg) source only: the original's strided int32 and
// float32 band sources feed its fused band encode, which the port's CUDA
// HT encoder replaces), its band-plane decode entry, the prepass (serial,
// without the original's thread-count argument) and the refined
// single-block entries.
// The routes of the CUDA HT kernels (csrc/ht_enc.cu, csrc/ht_dec.cu) do
// not run this coder; the host runs it for the code-blocks those kernels
// do not code: blocks with refinement passes and bands whose Mb + 3
// exceeds 32 (t1/backend.py).
//
// The batch entries (grok_ht_decode_bands and the refined band entries at
// the end, which the original does not have) take their worker count from
// the caller and run on std::thread workers that take code-blocks from
// one atomic counter (the original's OpenMP loops; the port's host
// library builds without OpenMP). Each block writes only its own output
// slot or band rectangle, so the output does not depend on the thread
// count. Built with g++ (ops/_build.host_library).
//
// From the original's header: written from the FBCOT algorithm structure
// (quad-pair scanning, MEL/VLC/MagSgn triple stream) as standardized in
// ISO/IEC 15444-15; stream framing and conventions match the reference
// codec for interoperability (reference: src/lib/jp2/t1/t1_ht/coding/
// ojph_block_encoder.cpp:465, ojph_block_decoder.cpp:687). The CxtVLC
// codeword tables are normative constants (ht_tables.inc, generated by
// ops/ht_tables.py as gen_ht_tables.py generates the original's).

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "ht_tables.inc"

namespace {

static inline int bit_length(uint32_t v) {
  return v ? 32 - __builtin_clz(v) : 0;
}

// ---------------------------------------------------------------------------
// Derived LUTs
// ---------------------------------------------------------------------------

// Encode LUT: [(c_q<<8)|(rho<<4)|eps] -> (cwd<<8)|(len<<4)|e_k
static uint16_t enc_tbl0[2048], enc_tbl1[2048];
// Decode LUT: [(c_q<<7)|cwd7] -> (e_k<<12)|(e_1<<8)|(rho<<4)|(u_off<<3)|len
static uint16_t dec_tbl0[1024], dec_tbl1[1024];

struct SrcEntry {
  int c_q, rho, u_off, e_k, e_1, cwd, len;
};

static SrcEntry unpack(uint32_t w) {
  SrcEntry e;
  e.c_q = (w >> 28) & 0xF;
  e.rho = (w >> 24) & 0xF;
  e.u_off = (w >> 23) & 1;
  e.e_k = (w >> 19) & 0xF;
  e.e_1 = (w >> 15) & 0xF;
  e.cwd = (w >> 7) & 0xFF;
  e.len = w & 0x7F;
  return e;
}

static void build_tables(const uint32_t* src, size_t n, uint16_t* enc,
                         uint16_t* dec) {
  for (int i = 0; i < 2048; i++) {
    int c_q = i >> 8, rho = (i >> 4) & 0xF, emb = i & 0xF;
    enc[i] = 0;
    if (((emb & rho) != emb) || (rho == 0 && c_q == 0)) continue;
    int best = -1, best_ones = -1;
    for (size_t j = 0; j < n; j++) {
      SrcEntry e = unpack(src[j]);
      if (e.c_q != c_q || e.rho != rho) continue;
      if (emb) {
        if (e.u_off == 1 && (emb & e.e_k) == e.e_1) {
          int ones = __builtin_popcount(e.e_k);
          if (ones >= best_ones) { best = (int)j; best_ones = ones; }
        }
      } else if (e.u_off == 0) {
        best = (int)j;
        break;
      }
    }
    if (best >= 0) {
      SrcEntry e = unpack(src[best]);
      enc[i] = (uint16_t)((e.cwd << 8) | (e.len << 4) | e.e_k);
    }
  }
  for (int i = 0; i < 1024; i++) {
    int cwd = i & 0x7F, c_q = i >> 7;
    dec[i] = 0;
    for (size_t j = 0; j < n; j++) {
      SrcEntry e = unpack(src[j]);
      if (e.c_q == c_q && e.cwd == (cwd & ((1 << e.len) - 1)))
        dec[i] = (uint16_t)((e.e_k << 12) | (e.e_1 << 8) | (e.rho << 4)
                            | (e.u_off << 3) | e.len);
    }
  }
}

// UVLC prefix/suffix codewords for u in 0..32.
static int uvlc_pre[33], uvlc_pre_len[33], uvlc_suf[33], uvlc_suf_len[33];

static void build_uvlc() {
  const int pre[5] = {0, 1, 2, 4, 4};
  const int pre_len[5] = {0, 1, 2, 3, 3};
  const int suf[5] = {0, 0, 0, 0, 1};
  const int suf_len[5] = {0, 0, 0, 1, 1};
  for (int i = 0; i < 5; i++) {
    uvlc_pre[i] = pre[i];
    uvlc_pre_len[i] = pre_len[i];
    uvlc_suf[i] = suf[i];
    uvlc_suf_len[i] = suf_len[i];
  }
  for (int i = 5; i < 33; i++) {
    uvlc_pre[i] = 0;
    uvlc_pre_len[i] = 3;
    uvlc_suf[i] = i - 5;
    uvlc_suf_len[i] = 5;
  }
}

static struct TablesInit {
  TablesInit() {
    build_tables(HT_VLC_SRC0, sizeof(HT_VLC_SRC0) / 4, enc_tbl0, dec_tbl0);
    build_tables(HT_VLC_SRC1, sizeof(HT_VLC_SRC1) / 4, enc_tbl1, dec_tbl1);
    build_uvlc();
  }
} tables_init;

static const int MEL_EXP[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};

// ---------------------------------------------------------------------------
// Stream writers
// ---------------------------------------------------------------------------

// Per-thread reusable stream slabs: the three coders write through raw
// pointers into preallocated buffers (no per-byte capacity checks);
// capacity persists across blocks so a batch does no allocation after
// warmup.
struct Scratch {
  std::vector<uint8_t> mel, vlcr, ms, e_val, cx_val;
  // Row-pair SoA precompute (vectorized): per quad column.
  std::vector<uint8_t> rho_a, emax_a, eps_a, e1_a, e3_a;
  std::vector<uint32_t> s0_a, s1_a, s2_a, s3_a, zrow;
  std::vector<uint8_t> zrow8;
  void ensure(size_t wh) {
    if (ms.size() < wh * 4 + 64) {
      ms.resize(wh * 4 + 64);
      vlcr.resize(wh * 2 + 64);
      mel.resize(wh / 2 + 64);
    }
  }
  void ensure_rows(int w) {
    size_t qw = (size_t)(w + 1) / 2 + 2;
    if (rho_a.size() < qw) {
      rho_a.resize(qw); emax_a.resize(qw); eps_a.resize(qw);
      e1_a.resize(qw); e3_a.resize(qw);
      s0_a.resize(qw); s1_a.resize(qw); s2_a.resize(qw); s3_a.resize(qw);
    }
    if (zrow.size() < (size_t)w + 2) {
      zrow.assign((size_t)w + 2, 0);
      zrow8.assign((size_t)w + 2, 0);
    }
  }
};
static Scratch& scratch() {
  static thread_local Scratch s;
  return s;
}

struct MelEnc {
  uint8_t* buf;
  size_t n = 0;
  int remaining = 8, tmp = 0, run = 0, k = 0, threshold = 1;

  explicit MelEnc(uint8_t* b) : buf(b) {}

  inline void emit_bit(int v) {
    tmp = (tmp << 1) | v;
    if (--remaining == 0) {
      buf[n++] = (uint8_t)tmp;
      remaining = (tmp == 0xFF) ? 7 : 8;
      tmp = 0;
    }
  }

  void encode(bool bit) {
    if (!bit) {
      if (++run >= threshold) {
        emit_bit(1);
        run = 0;
        k = k + 1 < 12 ? k + 1 : 12;
        threshold = 1 << MEL_EXP[k];
      }
    } else {
      emit_bit(0);
      for (int t = MEL_EXP[k]; t > 0;)
        emit_bit((run >> --t) & 1);
      run = 0;
      k = k > 0 ? k - 1 : 0;
      threshold = 1 << MEL_EXP[k];
    }
  }
};

// Backward-growing VLC writer (bytes are emitted back-to-front).
struct VlcEnc {
  uint8_t* rbuf;  // reversed order: rbuf[0] is the LAST byte
  size_t n = 0;
  int used = 4, tmp = 0xF;
  bool last_gt_8f = true;
  uint64_t q = 0;   // pending bit queue (LSB first)
  int qbits = 0;

  explicit VlcEnc(uint8_t* b) : rbuf(b) { rbuf[n++] = 0xFF; }

  inline void drain_to(int floor_bits) {
    while (qbits > floor_bits) {
      int avail = 8 - (last_gt_8f ? 1 : 0) - used;
      int t = avail < qbits ? avail : qbits;
      tmp |= (int)(q & ((1u << t) - 1)) << used;
      used += t;
      avail -= t;
      qbits -= t;
      q >>= t;
      if (avail == 0) {
        if (last_gt_8f && tmp != 0x7F) {
          last_gt_8f = false;
          continue;  // the eighth bit is usable after all
        }
        rbuf[n++] = (uint8_t)tmp;
        last_gt_8f = tmp > 0x8F;
        tmp = 0;
        used = 0;
      }
    }
  }

  inline void encode(int cwd, int len) {
    uint64_t mask = (len < 64) ? ((1ull << len) - 1) : ~0ull;
    q |= ((uint64_t)(uint32_t)cwd & mask) << qbits;
    qbits += len;
    if (qbits >= 32) drain_to(0);
  }

  inline void flush_queue() { drain_to(0); }
};

static void terminate_mel_vlc(MelEnc& mel, VlcEnc& vlc) {
  vlc.flush_queue();
  if (mel.run > 0) mel.emit_bit(1);
  mel.tmp <<= mel.remaining;
  int mel_mask = (0xFF << mel.remaining) & 0xFF;
  int vlc_mask = 0xFF >> (8 - vlc.used);
  if ((mel_mask | vlc_mask) == 0) return;
  int fuse = mel.tmp | vlc.tmp;
  if ((((fuse ^ mel.tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask)) == 0
      && fuse != 0xFF && vlc.n > 1) {
    mel.buf[mel.n++] = (uint8_t)fuse;
  } else {
    mel.buf[mel.n++] = (uint8_t)mel.tmp;  // cannot be 0xFF here
    vlc.rbuf[vlc.n++] = (uint8_t)vlc.tmp;
  }
}

// MagSgn writer: 64-bit bit queue drained a byte at a time (the byte
// sequence, including 0xFF 7-bit stuffing, is identical to emitting
// bit-chunks into per-byte buffers — a byte is complete once max_bits
// bits are queued).
struct MsEnc {
  uint8_t* buf;
  size_t n = 0;
  uint64_t q = 0;
  int qbits = 0, max_bits = 8;

  explicit MsEnc(uint8_t* b) : buf(b) {}

  inline void drain() {
    // Bulk fast path: 4 plain bytes at once when none is 0xFF (stuffing
    // only ever follows an 0xFF byte).
    while (qbits >= 32 && max_bits == 8) {
      uint32_t w32 = (uint32_t)q;
      uint32_t x = w32 ^ 0xFFFFFFFFu;  // has-zero-byte test on ~w
      if ((x - 0x01010101u) & ~x & 0x80808080u) break;  // contains 0xFF
      std::memcpy(buf + n, &w32, 4);
      n += 4;
      q >>= 32;
      qbits -= 32;
    }
    while (qbits >= max_bits) {
      uint8_t byte = (uint8_t)(q & ((1u << max_bits) - 1));
      q >>= max_bits;
      qbits -= max_bits;
      buf[n++] = byte;
      max_bits = (byte == 0xFF) ? 7 : 8;
    }
  }

  inline void encode(uint32_t cwd, int len) {
    if (qbits + len > 64) drain();
    q |= (uint64_t)cwd << qbits;
    qbits += len;
    if (qbits >= 32) drain();
  }

  // one push for a whole quad's MagSgn bits (len <= ~56)
  inline void encode64(uint64_t cwd, int len) {
    if (qbits + len > 64) drain();
    q |= cwd << qbits;
    qbits += len;
    if (qbits >= 32) drain();
  }

  void terminate() {
    drain();
    if (qbits) {
      uint8_t byte = (uint8_t)(q | (0xFFu << qbits)) &
                     (uint8_t)((1u << max_bits) - 1);
      if (byte != 0xFF) buf[n++] = byte;
    } else if (max_bits == 7) {
      n--;
    }
  }
};

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

struct QuadInfo {
  int rho = 0;
  int e_q[4] = {0, 0, 0, 0};
  int e_qmax = 0;
  uint32_t s[4] = {0, 0, 0, 0};
};

// Gather one 2x2 quad at (x, y) from (mag, neg) arrays.
static inline void quad_sample(QuadInfo& q, int n, uint32_t m, uint32_t sign,
                               int shift, int p) {
  uint32_t val = (m << shift) << 1;  // sign-magnitude alignment, drop-sign
  val >>= p;
  val &= ~1u;
  if (val) {
    q.rho |= 1 << n;
    q.e_q[n] = bit_length(val - 1);
    if (q.e_q[n] > q.e_qmax) q.e_qmax = q.e_q[n];
    q.s[n] = (val - 2) + sign;  // v_n = 2(mu_p - 1) + s_n
  }
}

static inline QuadInfo gather_quad(const uint32_t* mag, const uint8_t* neg,
                                   int w, int h, int x, int y, int shift,
                                   int p) {
  QuadInfo q;
  if (x + 1 < w && y + 1 < h) {  // interior fast path (no bounds checks)
    const uint32_t* m0 = mag + (size_t)y * w + x;
    const uint32_t* m1 = m0 + w;
    const uint8_t* n0 = neg + (size_t)y * w + x;
    const uint8_t* n1 = n0 + w;
    quad_sample(q, 0, m0[0], n0[0], shift, p);
    quad_sample(q, 1, m1[0], n1[0], shift, p);
    quad_sample(q, 2, m0[1], n0[1], shift, p);
    quad_sample(q, 3, m1[1], n1[1], shift, p);
    return q;
  }
  const int dx[4] = {0, 0, 1, 1};
  const int dy[4] = {0, 1, 0, 1};
  for (int n = 0; n < 4; n++) {
    int xx = x + dx[n], yy = y + dy[n];
    if (xx >= w || yy >= h) continue;
    quad_sample(q, n, mag[yy * w + xx], neg[yy * w + xx] ? 1u : 0u, shift,
                p);
  }
  return q;
}

// Vectorizable per-row-pair precompute: significance/exponent/value for
// every quad column in one SoA pass (the emission loop then only does
// table lookups and bit pushes). eps_a is the raw (e_n == e_qmax)
// pattern; callers apply it only when u_q > 0, matching gather_quad's
// conditional eps computation.
static void precompute_rowpair(const uint32_t* mag, const uint8_t* neg,
                               int w, int h, int y, int shift, int p,
                               Scratch& s) {
  const uint32_t* r0 = mag + (size_t)y * w;
  const uint8_t* n0 = neg + (size_t)y * w;
  bool h2 = y + 1 < h;
  const uint32_t* r1 = h2 ? r0 + w : s.zrow.data();
  const uint8_t* n1 = h2 ? n0 + w : s.zrow8.data();
  int full = w / 2;
  uint8_t* rho = s.rho_a.data();
  uint8_t* emax = s.emax_a.data();
  uint8_t* eps = s.eps_a.data();
  uint8_t* e1 = s.e1_a.data();
  uint8_t* e3 = s.e3_a.data();
  uint32_t* s0 = s.s0_a.data();
  uint32_t* s1 = s.s1_a.data();
  uint32_t* s2 = s.s2_a.data();
  uint32_t* s3 = s.s3_a.data();
#pragma GCC ivdep
  for (int qx = 0; qx < full; qx++) {
    uint32_t ma = r0[2 * qx], mb = r1[2 * qx];
    uint32_t mc = r0[2 * qx + 1], md = r1[2 * qx + 1];
    uint32_t va = (((ma << shift) << 1) >> p) & ~1u;
    uint32_t vb = (((mb << shift) << 1) >> p) & ~1u;
    uint32_t vc = (((mc << shift) << 1) >> p) & ~1u;
    uint32_t vd = (((md << shift) << 1) >> p) & ~1u;
    int ea = va ? 32 - __builtin_clz(va - 1) : 0;
    int eb = vb ? 32 - __builtin_clz(vb - 1) : 0;
    int ec = vc ? 32 - __builtin_clz(vc - 1) : 0;
    int ed = vd ? 32 - __builtin_clz(vd - 1) : 0;
    int r = (va ? 1 : 0) | (vb ? 2 : 0) | (vc ? 4 : 0) | (vd ? 8 : 0);
    int em = ea > eb ? ea : eb;
    em = ec > em ? ec : em;
    em = ed > em ? ed : em;
    rho[qx] = (uint8_t)r;
    emax[qx] = (uint8_t)em;
    eps[qx] = (uint8_t)(((ea == em) ? 1 : 0) | ((eb == em) ? 2 : 0)
                        | ((ec == em) ? 4 : 0) | ((ed == em) ? 8 : 0));
    e1[qx] = (uint8_t)eb;
    e3[qx] = (uint8_t)ed;
    s0[qx] = va - 2 + (uint32_t)(n0[2 * qx] ? 1 : 0);
    s1[qx] = vb - 2 + (uint32_t)(n1[2 * qx] ? 1 : 0);
    s2[qx] = vc - 2 + (uint32_t)(n0[2 * qx + 1] ? 1 : 0);
    s3[qx] = vd - 2 + (uint32_t)(n1[2 * qx + 1] ? 1 : 0);
  }
  if (w & 1) {  // half quad: right column absent
    int qx = full;
    uint32_t ma = r0[w - 1], mb = r1[w - 1];
    uint32_t va = (((ma << shift) << 1) >> p) & ~1u;
    uint32_t vb = (((mb << shift) << 1) >> p) & ~1u;
    int ea = va ? 32 - __builtin_clz(va - 1) : 0;
    int eb = vb ? 32 - __builtin_clz(vb - 1) : 0;
    int em = ea > eb ? ea : eb;
    rho[qx] = (uint8_t)((va ? 1 : 0) | (vb ? 2 : 0));
    emax[qx] = (uint8_t)em;
    eps[qx] = (uint8_t)(((ea == em) ? 1 : 0) | ((eb == em) ? 2 : 0)
                        | ((0 == em) ? 4 : 0) | ((0 == em) ? 8 : 0));
    e1[qx] = (uint8_t)eb;
    e3[qx] = 0;
    s0[qx] = va - 2 + (uint32_t)(n0[w - 1] ? 1 : 0);
    s1[qx] = vb - 2 + (uint32_t)(n1[w - 1] ? 1 : 0);
    s2[qx] = 0;
    s3[qx] = 0;
  }
  // one sentinel quad past the end (q1 loads at x+2 >= w read it)
  int qw = (w + 1) / 2;
  rho[qw] = 0; emax[qw] = 0; eps[qw] = 0; e1[qw] = 0; e3[qw] = 0;
  s0[qw] = s1[qw] = s2[qw] = s3[qw] = 0;
}

struct SrcU32 { const uint32_t* mag; const uint8_t* neg; };

static inline void src_rowpair(const SrcU32& r, int w, int h, int y,
                               int shift, int p, Scratch& s) {
  precompute_rowpair(r.mag, r.neg, w, h, y, shift, p, s);
}

static inline void load_quad(const Scratch& s, int qx, QuadInfo& q) {
  q.rho = s.rho_a[qx];
  q.e_qmax = s.emax_a[qx];
  q.e_q[1] = s.e1_a[qx];
  q.e_q[3] = s.e3_a[qx];
  q.s[0] = s.s0_a[qx];
  q.s[1] = s.s1_a[qx];
  q.s[2] = s.s2_a[qx];
  q.s[3] = s.s3_a[qx];
}

// Pack the 4 MagSgn contributions of one quad into a single bit push.
static inline void ms_encode_quad(MsEnc& ms, const QuadInfo& q, int Uq,
                                  uint16_t t) {
  int m0 = (q.rho >> 0) & 1 ? Uq - ((t >> 0) & 1) : 0;
  int m1 = (q.rho >> 1) & 1 ? Uq - ((t >> 1) & 1) : 0;
  int m2 = (q.rho >> 2) & 1 ? Uq - ((t >> 2) & 1) : 0;
  int m3 = (q.rho >> 3) & 1 ? Uq - ((t >> 3) & 1) : 0;
  int total = m0 + m1 + m2 + m3;
  if (total <= 56) {  // common case: one branchless combined push
    // 64-bit shifts keep m in [0, 56] well-defined.
    uint64_t k0 = ((uint64_t)1 << m0) - 1, k1 = ((uint64_t)1 << m1) - 1;
    uint64_t k2 = ((uint64_t)1 << m2) - 1, k3 = ((uint64_t)1 << m3) - 1;
    uint64_t cw = (q.s[0] & k0);
    cw |= (q.s[1] & k1) << m0;
    cw |= (q.s[2] & k2) << (m0 + m1);
    cw |= (q.s[3] & k3) << (m0 + m1 + m2);
    ms.encode64(cw, total);
    return;
  }
  // high-precision quads: per-sample with overflow flushes
  const int mm[4] = {m0, m1, m2, m3};
  uint64_t cw = 0;
  int cl = 0;
  for (int n = 0; n < 4; n++) {
    int m = mm[n];
    if (cl + m > 56) {
      ms.encode64(cw, cl);
      cw = 0;
      cl = 0;
    }
    uint32_t mask = m < 32 ? ((1u << m) - 1u) : 0xFFFFFFFFu;
    cw |= ((uint64_t)(q.s[n] & mask)) << cl;
    cl += m;
  }
  ms.encode64(cw, cl);
}

// Encode one HT cleanup segment into dst (capacity >= 6*w*h + 64).
// Returns the segment length in bytes.
template <class Src>
static int ht_encode_t(const Src& src, int w, int h, int Mb,
                       uint8_t* dst) {
  Scratch& s = scratch();
  s.ensure((size_t)w * h);
  MelEnc mel(s.mel.data());
  VlcEnc vlc(s.vlcr.data());
  MsEnc ms(s.ms.data());

  int shift = 31 - (Mb + 1);  // align magnitudes like the reference wrapper
  int p = 30 - Mb;            // missing_msbs at encode time = Mb

  int qw = (w + 1) / 2;  // quad columns
  s.e_val.assign(qw + 2, 0);
  s.cx_val.assign(qw + 2, 0);
  s.ensure_rows(w);
  std::vector<uint8_t>& e_val = s.e_val;
  std::vector<uint8_t>& cx_val = s.cx_val;

  // ---- initial row pair ----
  {
    src_rowpair(src, w, h, 0, shift, p, s);
    uint8_t* lep = e_val.data();
    uint8_t* lcxp = cx_val.data();
    lep[0] = 0;
    lcxp[0] = 0;
    int c_q0 = 0;
    for (int x = 0; x < w; x += 4) {
      QuadInfo q0;
      load_quad(s, x >> 1, q0);
      int Uq0 = q0.e_qmax > 1 ? q0.e_qmax : 1;
      int u_q0 = Uq0 - 1, u_q1 = 0;
      int eps0 = u_q0 > 0 ? s.eps_a[x >> 1] : 0;
      lep[0] = lep[0] > q0.e_q[1] ? lep[0] : (uint8_t)q0.e_q[1];
      lep++;
      lep[0] = (uint8_t)q0.e_q[3];
      lcxp[0] |= (q0.rho & 2) >> 1;
      lcxp++;
      lcxp[0] = (uint8_t)((q0.rho & 8) >> 3);

      uint16_t t0 = enc_tbl0[(c_q0 << 8) | (q0.rho << 4) | eps0];
      vlc.encode(t0 >> 8, (t0 >> 4) & 7);
      if (c_q0 == 0) mel.encode(q0.rho != 0);
      ms_encode_quad(ms, q0, Uq0, t0);

      int c_q1 = (q0.rho >> 1) | (q0.rho & 1);
      QuadInfo q1;
      if (x + 2 < w) {
        load_quad(s, (x >> 1) + 1, q1);
        int Uq1 = q1.e_qmax > 1 ? q1.e_qmax : 1;
        u_q1 = Uq1 - 1;
        int eps1 = u_q1 > 0 ? s.eps_a[(x >> 1) + 1] : 0;
        lep[0] = lep[0] > q1.e_q[1] ? lep[0] : (uint8_t)q1.e_q[1];
        lep++;
        lep[0] = (uint8_t)q1.e_q[3];
        lcxp[0] |= (q1.rho & 2) >> 1;
        lcxp++;
        lcxp[0] = (uint8_t)((q1.rho & 8) >> 3);

        uint16_t t1 = enc_tbl0[(c_q1 << 8) | (q1.rho << 4) | eps1];
        vlc.encode(t1 >> 8, (t1 >> 4) & 7);
        if (c_q1 == 0) mel.encode(q1.rho != 0);
        ms_encode_quad(ms, q1, Uq1, t1);
      }

      // UVLC for the quad pair (initial-row rules).
      if (u_q0 > 0 && u_q1 > 0)
        mel.encode((u_q0 < u_q1 ? u_q0 : u_q1) > 2);
      if (u_q0 > 2 && u_q1 > 2) {
        int a = u_q0 - 2, b = u_q1 - 2;
        int l0 = uvlc_pre_len[a], l1 = uvlc_pre_len[b];
        int l2 = uvlc_suf_len[a];
        vlc.encode(uvlc_pre[a] | (uvlc_pre[b] << l0)
                       | (uvlc_suf[a] << (l0 + l1))
                       | (uvlc_suf[b] << (l0 + l1 + l2)),
                   l0 + l1 + l2 + uvlc_suf_len[b]);
      } else if (u_q0 > 2 && u_q1 > 0) {
        int l0 = uvlc_pre_len[u_q0];
        vlc.encode(uvlc_pre[u_q0] | ((u_q1 - 1) << l0)
                       | (uvlc_suf[u_q0] << (l0 + 1)),
                   l0 + 1 + uvlc_suf_len[u_q0]);
      } else {
        int l0 = uvlc_pre_len[u_q0], l1 = uvlc_pre_len[u_q1];
        int l2 = uvlc_suf_len[u_q0];
        vlc.encode(uvlc_pre[u_q0] | (uvlc_pre[u_q1] << l0)
                       | (uvlc_suf[u_q0] << (l0 + l1))
                       | (uvlc_suf[u_q1] << (l0 + l1 + l2)),
                   l0 + l1 + l2 + uvlc_suf_len[u_q1]);
      }
      c_q0 = (q1.rho >> 1) | (q1.rho & 1);
    }
  }

  // ---- non-initial row pairs ----
  for (int y = 2; y < h; y += 2) {
    src_rowpair(src, w, h, y, shift, p, s);
    uint8_t* lep = e_val.data();
    uint8_t* lcxp = cx_val.data();
    int max_e = (lep[0] > lep[1] ? lep[0] : lep[1]) - 1;
    lep[0] = 0;
    int c_q0 = lcxp[0] + (lcxp[1] << 2);
    lcxp[0] = 0;
    for (int x = 0; x < w; x += 4) {
      QuadInfo q0;
      load_quad(s, x >> 1, q0);
      int kappa = (q0.rho & (q0.rho - 1)) ? (max_e > 1 ? max_e : 1) : 1;
      int Uq0 = q0.e_qmax > kappa ? q0.e_qmax : kappa;
      int u_q0 = Uq0 - kappa, u_q1 = 0;
      int eps0 = u_q0 > 0 ? s.eps_a[x >> 1] : 0;
      lep[0] = lep[0] > q0.e_q[1] ? lep[0] : (uint8_t)q0.e_q[1];
      lep++;
      max_e = (lep[0] > lep[1] ? lep[0] : lep[1]) - 1;
      lep[0] = (uint8_t)q0.e_q[3];
      lcxp[0] |= (q0.rho & 2) >> 1;
      lcxp++;
      int c_q1 = lcxp[0] + (lcxp[1] << 2);
      lcxp[0] = (uint8_t)((q0.rho & 8) >> 3);

      uint16_t t0 = enc_tbl1[(c_q0 << 8) | (q0.rho << 4) | eps0];
      vlc.encode(t0 >> 8, (t0 >> 4) & 7);
      if (c_q0 == 0) mel.encode(q0.rho != 0);
      ms_encode_quad(ms, q0, Uq0, t0);

      QuadInfo q1;
      if (x + 2 < w) {
        load_quad(s, (x >> 1) + 1, q1);
        kappa = (q1.rho & (q1.rho - 1)) ? (max_e > 1 ? max_e : 1) : 1;
        c_q1 |= ((q0.rho & 4) >> 1) | ((q0.rho & 8) >> 2);
        int Uq1 = q1.e_qmax > kappa ? q1.e_qmax : kappa;
        u_q1 = Uq1 - kappa;
        int eps1 = u_q1 > 0 ? s.eps_a[(x >> 1) + 1] : 0;
        lep[0] = lep[0] > q1.e_q[1] ? lep[0] : (uint8_t)q1.e_q[1];
        lep++;
        max_e = (lep[0] > lep[1] ? lep[0] : lep[1]) - 1;
        lep[0] = (uint8_t)q1.e_q[3];
        lcxp[0] |= (q1.rho & 2) >> 1;
        lcxp++;
        c_q0 = lcxp[0] + (lcxp[1] << 2);
        lcxp[0] = (uint8_t)((q1.rho & 8) >> 3);

        uint16_t t1 = enc_tbl1[(c_q1 << 8) | (q1.rho << 4) | eps1];
        vlc.encode(t1 >> 8, (t1 >> 4) & 7);
        if (c_q1 == 0) mel.encode(q1.rho != 0);
        ms_encode_quad(ms, q1, Uq1, t1);
      } else {
        // still consume the c_q0 context for the next pair
        c_q0 = lcxp[0] + (lcxp[1] << 2);
      }

      {
        int l0 = uvlc_pre_len[u_q0], l1 = uvlc_pre_len[u_q1];
        int l2 = uvlc_suf_len[u_q0];
        vlc.encode(uvlc_pre[u_q0] | (uvlc_pre[u_q1] << l0)
                       | (uvlc_suf[u_q0] << (l0 + l1))
                       | (uvlc_suf[u_q1] << (l0 + l1 + l2)),
                   l0 + l1 + l2 + uvlc_suf_len[u_q1]);
      }

      c_q0 |= ((q1.rho & 4) >> 1) | ((q1.rho & 8) >> 2);
    }
  }

  terminate_mel_vlc(mel, vlc);
  ms.terminate();

  // Assemble: MagSgn || MEL || reverse(VLC); last two bytes carry Scup.
  uint8_t* wp = dst;
  std::memcpy(wp, ms.buf, ms.n);
  wp += ms.n;
  std::memcpy(wp, mel.buf, mel.n);
  wp += mel.n;
  for (size_t i = vlc.n; i > 0; i--) *wp++ = vlc.rbuf[i - 1];
  int scup = (int)(mel.n + vlc.n);
  size_t L = (size_t)(wp - dst);
  dst[L - 1] = (uint8_t)(scup >> 4);
  dst[L - 2] = (uint8_t)((dst[L - 2] & 0xF0) | (scup & 0xF));
  return (int)L;
}

static int ht_encode(const uint32_t* mag, const uint8_t* neg, int w, int h,
                     int Mb, uint8_t* dst) {
  return ht_encode_t(SrcU32{mag, neg}, w, h, Mb, dst);
}

// ---------------------------------------------------------------------------
// Stream readers
// ---------------------------------------------------------------------------

struct MelDec {
  const uint8_t* data;
  int size;       // bytes available (scup - 1)
  uint64_t tmp = 0;
  int bits = 0;
  bool unstuff = false;
  int k = 0;
  int pos = 0;

  MelDec(const uint8_t* d, int sz) : data(d), size(sz) {}

  void read_byte() {
    uint64_t d = (pos < size) ? data[pos] : 0xFF;
    if (pos == size - 1) d |= 0xF;  // last byte's low nibble holds Scup bits
    pos++;
    int d_bits = 8 - (unstuff ? 1 : 0);
    tmp = (tmp << d_bits) | d;
    bits += d_bits;
    unstuff = (d & 0xFF) == 0xFF;
  }

  // Decode one MEL event's run value (LSB set = run terminated by a 1).
  int get_run() {
    while (bits < 6) read_byte();
    int eval = MEL_EXP[k];
    int run;
    if ((tmp >> (bits - 1)) & 1) {  // MSB of buffer: a full run of 2^eval
      run = ((1 << eval) - 1) << 1;  // not terminating
      k = k + 1 < 12 ? k + 1 : 12;
      bits -= 1;
    } else {
      run = (int)((tmp >> (bits - 1 - eval)) & ((1 << eval) - 1));
      run = (run << 1) + 1;  // terminating with a 1
      k = k > 0 ? k - 1 : 0;
      bits -= eval + 1;
    }
    return run;
  }
};

// Backward VLC reader (reads bytes back-to-front with unstuffing).
struct VlcDec {
  const uint8_t* data;   // points at next byte to read (moving backward)
  int size;
  uint64_t tmp;
  int bits;
  bool unstuff;

  VlcDec(const uint8_t* buf, int lcup, int scup) {
    data = buf + lcup - 2;
    size = scup - 2;
    uint32_t d = *data--;
    tmp = d >> 4;
    bits = 4 - (((tmp & 7) == 7) ? 1 : 0);
    unstuff = (d | 0xF) > 0x8F;
  }

  void read_byte() {
    uint64_t d = (size > 0) ? *data : 0;
    data--;
    size--;
    int d_bits = 8 - ((unstuff && ((d & 0x7F) == 0x7F)) ? 1 : 0);
    tmp |= d << bits;
    bits += d_bits;
    unstuff = d > 0x8F;
  }

  uint32_t fetch() {
    while (bits < 32) read_byte();
    return (uint32_t)tmp;
  }

  void advance(int n) {
    tmp >>= n;
    bits -= n;
  }
};

// Forward MagSgn reader (pads with 0xFF past the end).
struct MsDec {
  const uint8_t* data;
  int size;
  uint64_t tmp = 0;
  int bits = 0;
  bool unstuff = false;
  int pos = 0;

  MsDec(const uint8_t* d, int sz) : data(d), size(sz) {}

  void read_byte() {
    uint64_t d = (pos < size) ? data[pos] : 0xFF;
    pos++;
    int d_bits = 8 - (unstuff ? 1 : 0);
    tmp |= d << bits;
    bits += d_bits;
    unstuff = (d & 0xFF) == 0xFF;
  }

  uint32_t fetch() {
    while (bits < 32) read_byte();
    return (uint32_t)tmp;
  }

  void advance(int n) {
    tmp >>= n;
    bits -= n;
  }
};

// UVLC prefix decode helper: returns packed (consumed<<?)... decodes the
// 3-bit prefix class from the low bits of `vlc`.
struct UvlcPart {
  int pre_len;   // prefix bits consumed
  int suf_len;   // suffix bits
  int base;      // prefix value
};

static inline UvlcPart uvlc_classify(uint32_t vlc) {
  // prefix codes: 1 -> u=1; 01 -> u=2; 001 -> u=3..4 (1 suffix bit);
  // 000 -> u=5..36 (5 suffix bits)
  if (vlc & 1) return {1, 0, 1};
  if ((vlc & 3) == 2) return {2, 0, 2};
  if ((vlc & 7) == 4) return {3, 1, 3};
  return {3, 5, 5};
}

// Decode u values for a quad pair; returns consumed bits.
static int uvlc_decode(uint32_t vlc, int mode, bool initial, int* u) {
  int consumed = 0;
  u[0] = u[1] = 0;
  if (mode == 0) return 0;
  if (mode <= 2) {
    UvlcPart c = uvlc_classify(vlc);
    vlc >>= c.pre_len;
    consumed = c.pre_len + c.suf_len;
    int val = c.base + (int)(vlc & ((1u << c.suf_len) - 1));
    u[mode == 1 ? 0 : 1] = val;
    return consumed;
  }
  if (mode == 3 && initial) {
    UvlcPart c1 = uvlc_classify(vlc);
    vlc >>= c1.pre_len;
    consumed = c1.pre_len;
    if (c1.pre_len > 2) {
      // u_q1 in {1, 2}, coded with a single extra bit
      u[1] = (int)(vlc & 1) + 1;
      vlc >>= 1;
      consumed += 1;
      consumed += c1.suf_len;
      u[0] = c1.base + (int)(vlc & ((1u << c1.suf_len) - 1));
    } else {
      UvlcPart c2 = uvlc_classify(vlc);
      vlc >>= c2.pre_len;
      consumed += c2.pre_len;
      consumed += c1.suf_len;
      u[0] = c1.base + (int)(vlc & ((1u << c1.suf_len) - 1));
      vlc >>= c1.suf_len;
      consumed += c2.suf_len;
      u[1] = c2.base + (int)(vlc & ((1u << c2.suf_len) - 1));
    }
    return consumed;
  }
  if (mode == 4) {  // initial row, both u > 2: values offset by +2
    UvlcPart c1 = uvlc_classify(vlc);
    vlc >>= c1.pre_len;
    consumed = c1.pre_len;
    UvlcPart c2 = uvlc_classify(vlc);
    vlc >>= c2.pre_len;
    consumed += c2.pre_len;
    consumed += c1.suf_len;
    u[0] = c1.base + (int)(vlc & ((1u << c1.suf_len) - 1)) + 2;
    vlc >>= c1.suf_len;
    consumed += c2.suf_len;
    u[1] = c2.base + (int)(vlc & ((1u << c2.suf_len) - 1)) + 2;
    return consumed;
  }
  // mode == 3, non-initial: two independent codes
  {
    UvlcPart c1 = uvlc_classify(vlc);
    vlc >>= c1.pre_len;
    consumed = c1.pre_len;
    UvlcPart c2 = uvlc_classify(vlc);
    vlc >>= c2.pre_len;
    consumed += c2.pre_len;
    consumed += c1.suf_len;
    u[0] = c1.base + (int)(vlc & ((1u << c1.suf_len) - 1));
    vlc >>= c1.suf_len;
    consumed += c2.suf_len;
    u[1] = c2.base + (int)(vlc & ((1u << c2.suf_len) - 1));
    return consumed;
  }
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

// Decode the significant samples of one quad and update the per-quad-column
// line state (bit 7 = sigma of the quad's bottom-right sample; bits 0..6 =
// max exponent of the bottom samples), mirroring the reference data flow.
// Output sinks: classic (mag, neg) split arrays, signed int32 band rows,
// or float32 band rows with the mid-point dequantizer fused (float op
// order identical to ops.quant.dequantize_signed).
struct SinkU32 {
  uint32_t* mag;
  uint8_t* neg;
  int w;
  inline void write(int x, int y, uint32_t m, uint32_t sign) {
    mag[(size_t)y * w + x] = m;
    neg[(size_t)y * w + x] = (uint8_t)sign;
  }
};
struct SinkI32 {
  int32_t* base;
  int64_t stride;
  inline void write(int x, int y, uint32_t m, uint32_t sign) {
    base[(size_t)y * stride + x] = sign ? -(int32_t)m : (int32_t)m;
  }
};
struct SinkF32 {
  float* base;
  int64_t stride;
  float step;
  inline void write(int x, int y, uint32_t m, uint32_t sign) {
    float mm = (float)m;
    if (m) mm += 0.5f;
    float v = mm * step;
    base[(size_t)y * stride + x] = sign ? -v : v;
  }
};

template <class Sink>
struct QuadDecCtx {
  MsDec* magsgn;
  Sink sink;
  int w, h, p, out_shift;
};

template <class Sink>
static inline void decode_quad_samples(QuadDecCtx<Sink>& ctx, uint32_t qf,
                                       int U_p, int bx, int y,
                                       uint8_t*& lsp) {
  static const int dx[4] = {0, 0, 1, 1};
  static const int dy[4] = {0, 1, 0, 1};
  if ((qf & 0xF0) == 0) {  // fast path: fully insignificant quad
    ++lsp;
    lsp[0] = 0;
    return;
  }
  for (int n = 0; n < 4; n++) {
    int xx = bx + dx[n], yy = y + dy[n];
    bool sig = (qf >> (4 + n)) & 1;
    uint32_t v_n = 0;
    if (sig) {
      uint32_t ms_val = ctx.magsgn->fetch();
      int m_n = U_p - ((qf >> (12 + n)) & 1);
      ctx.magsgn->advance(m_n);
      uint32_t sign = ms_val & 1;
      v_n = ms_val & ((m_n < 32 ? (1u << m_n) : 0u) - 1u);
      v_n |= ((qf >> (8 + n)) & 1) << m_n;
      v_n |= 1;  // center of bin
      if (xx < ctx.w && yy < ctx.h) {
        uint64_t recon = ((uint64_t)(v_n + 2)) << (ctx.p - 1);
        ctx.sink.write(xx, yy, (uint32_t)(recon >> ctx.out_shift), sign);
      }
    }
    if (n == 1) {
      // bottom-left sample: fold into current line-state entry
      if (sig) {
        int s = (lsp[0] & 0x80) | 0x80;
        int t = lsp[0] & 0x7F;
        int e = bit_length(v_n);
        lsp[0] = (uint8_t)(s | (t > e ? t : e));
      }
      ++lsp;
      lsp[0] = 0;
    } else if (n == 3) {
      // bottom-right sample: initialize the next line-state entry
      if (sig) lsp[0] = (uint8_t)(0x80 | bit_length(v_n));
    }
  }
}

template <class Sink>
static bool ht_decode_t(const uint8_t* coded, int lcup, int w, int h,
                        int missing_msbs, Sink sink) {
  if (lcup < 2) return false;
  int p = 30 - missing_msbs;
  int out_shift = 31 - (missing_msbs + 1);
  int scup = (coded[lcup - 1] << 4) + (coded[lcup - 2] & 0xF);
  if (scup > lcup || scup < 2) return false;

  MelDec mel(coded + lcup - scup, scup - 1);
  VlcDec vlc(coded, lcup, scup);
  MsDec magsgn(coded, lcup - scup);

  int qw = (w + 1) / 2;
  std::vector<uint8_t> line_state(qw + 4, 0);
  QuadDecCtx<Sink> ctx{&magsgn, sink, w, h, p, out_shift};

  int run = mel.get_run();

  // ---- initial row pair ----
  {
    uint8_t* lsp = line_state.data();
    lsp[0] = 0;
    int c_p = 0;
    for (int x = 0; x < w; x += 4) {
      uint32_t qinf[2] = {0, 0};
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = dec_tbl0[(c_p << 7) | (vlc_val & 0x7F)];
      if (c_p == 0) {
        run -= 2;
        qinf[0] = (run == -1) ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_p = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5);
      vlc.advance(qinf[0] & 0x7);

      if (x + 2 < w) {
        vlc_val = vlc.fetch();
        qinf[1] = dec_tbl0[(c_p << 7) | (vlc_val & 0x7F)];
        if (c_p == 0) {
          run -= 2;
          qinf[1] = (run == -1) ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_p = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5);
        vlc.advance(qinf[1] & 0x7);
      }

      int uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      if (uvlc_mode == 3) {
        run -= 2;
        uvlc_mode += (run == -1) ? 1 : 0;
        if (run < 0) run = mel.get_run();
      }
      int u[2];
      int consumed = uvlc_decode(vlc.fetch(), uvlc_mode, true, u);
      vlc.advance(consumed);
      int U_p0 = u[0] + 1;  // kappa = 1 on the initial row
      int U_p1 = u[1] + 1;

      decode_quad_samples(ctx, qinf[0], U_p0, x, 0, lsp);
      if (x + 2 < w)
        decode_quad_samples(ctx, qinf[1], U_p1, x + 2, 0, lsp);
    }
  }

  // ---- non-initial row pairs ----
  for (int y = 2; y < h; y += 2) {
    uint8_t* lsp = line_state.data();
    uint8_t ls0 = lsp[0];
    lsp[0] = 0;
    int c_p = 0;
    for (int x = 0; x < w; x += 4) {
      uint32_t qinf[2] = {0, 0};
      // context from the row above: sigma^NW | sigma^N / sigma^NE
      c_p |= (ls0 >> 7);
      c_p |= (lsp[1] >> 5) & 0x4;
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = dec_tbl1[(c_p << 7) | (vlc_val & 0x7F)];
      if (c_p == 0) {
        run -= 2;
        qinf[0] = (run == -1) ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_p = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
      vlc.advance(qinf[0] & 0x7);

      if (x + 2 < w) {
        c_p |= (lsp[1] >> 7);
        c_p |= (lsp[2] >> 5) & 0x4;
        vlc_val = vlc.fetch();
        qinf[1] = dec_tbl1[(c_p << 7) | (vlc_val & 0x7F)];
        if (c_p == 0) {
          run -= 2;
          qinf[1] = (run == -1) ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_p = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
        vlc.advance(qinf[1] & 0x7);
      }

      int uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      int u[2];
      int consumed = uvlc_decode(vlc.fetch(), uvlc_mode, false, u);
      vlc.advance(consumed);
      // kappa = 1 baseline; quads with 2+ significant samples add the
      // exponent bonus from the row above (E_max - 2, if positive).
      int U_p0 = u[0] + 1;
      int U_p1 = u[1] + 1;
      if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
        int e = (ls0 & 0x7F);
        int e2 = (lsp[1] & 0x7F);
        e = (e > e2 ? e : e2) - 2;
        U_p0 += e > 0 ? e : 0;
      }
      if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
        int e = (lsp[1] & 0x7F);
        int e2 = (lsp[2] & 0x7F);
        e = (e > e2 ? e : e2) - 2;
        U_p1 += e > 0 ? e : 0;
      }

      ls0 = lsp[2];
      lsp[1] = lsp[2] = 0;

      decode_quad_samples(ctx, qinf[0], U_p0, x, y, lsp);
      if (x + 2 < w)
        decode_quad_samples(ctx, qinf[1], U_p1, x + 2, y, lsp);
    }
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// Worker threads over code-blocks
// ---------------------------------------------------------------------------

namespace {

// body(i) for i in [0, n) on min(nthreads, n) threads (the caller's
// thread among them), each taking the next index from one counter.
template <class F>
void parallel_for(int n, int nthreads, F&& body) {
  int nt = std::min(nthreads, n);
  if (nt <= 1) {
    for (int i = 0; i < n; i++) body(i);
    return;
  }
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) body(i);
  };
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int t = 1; t < nt; t++) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI: the cleanup coder
// ---------------------------------------------------------------------------

extern "C" {

// Decode one HT cleanup segment.
static bool ht_decode(const uint8_t* coded, int lcup, int w, int h,
                      int missing_msbs, uint32_t* mag, uint8_t* neg) {
  std::memset(mag, 0, sizeof(uint32_t) * (size_t)w * h);
  std::memset(neg, 0, (size_t)w * h);
  return ht_decode_t(coded, lcup, w, h, missing_msbs,
                     SinkU32{mag, neg, w});
}

// Decode straight into band coefficient planes: each block decodes into
// its rectangle of the (pre-zeroed) band plane with the sign applied —
// int32 for the reversible path, or float32 with the fused mid-point
// dequantizer ((|q|+0.5)*step, float32 op order identical to
// ops.quant.reconstruct) for irreversible.
// desc per block (int64 x 9):
//   [0]=data offset, [1]=data len, [2]=w, [3]=h, [4]=missing_msbs,
//   [5]=band index, [6]=x0, [7]=y0 (within band), [8]=unused
int grok_ht_decode_bands(int nblocks, const uint8_t* data_flat,
                         const int64_t* desc, const int64_t* band_ptrs,
                         const int64_t* band_strides, const double* steps,
                         int is_float, int nthreads) {
  parallel_for(nblocks, nthreads, [&](int i) {
    const int64_t* d = desc + (size_t)i * 9;
    int w = (int)d[2], h = (int)d[3];
    int64_t stride = band_strides[d[5]];
    // significant samples are written once, the others stay 0
    if (is_float) {
      float* dst = (float*)(uintptr_t)band_ptrs[d[5]]
          + (size_t)d[7] * stride + d[6];
      ht_decode_t(data_flat + d[0], (int)d[1], w, h, (int)d[4],
                  SinkF32{dst, stride, (float)steps[d[5]]});
    } else {
      int32_t* dst = (int32_t*)(uintptr_t)band_ptrs[d[5]]
          + (size_t)d[7] * stride + d[6];
      ht_decode_t(data_flat + d[0], (int)d[1], w, h, (int)d[4],
                  SinkI32{dst, stride});
    }
  });
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Device-decode prepass: expand HT cleanup segments into the dense
// unstuffed stream-word matrices the TPU decoder consumes
// (ops/ht_dec_jax.py _prepass_mel/_prepass_vlc/_prepass_ms — this is a
// bit-identical native mirror; the numpy version's per-byte
// bitwise_or.at scatters dominate fused device-decode wall time).
// Layout: (nwords, B) uint32, C-order (lane b of word w at w*B + b).
// MEL is MSB bit order (stream bit p at word bit 31-(p&31)); VLC and
// MagSgn are LSB order (bit p at word bit p&31). Byte payload widths
// follow each stream's unstuffing rule; the deposit always ORs the
// FULL byte so a 7-bit byte's top bit overlaps the next byte's first
// bit exactly like the forward readers (reference semantics:
// src/lib/jp2/t1/t1_ht/coding/ojph_block_decoder.cpp frwd/rev/MEL
// readers).
// ---------------------------------------------------------------------------

namespace {

struct LaneBuf {
  std::vector<uint32_t> w;
  void reset(int nwords) {
    w.assign((size_t)nwords + 2, 0);  // +2: overlap spill, dropped
  }
  inline void or_lsb_byte(int64_t p, uint32_t v) {
    uint64_t x = (uint64_t)v << (p & 31);
    w[(size_t)(p >> 5)] |= (uint32_t)x;
    w[(size_t)(p >> 5) + 1] |= (uint32_t)(x >> 32);
  }
  inline void or_msb_byte(int64_t p, uint32_t v) {
    // byte MSB-first starting at stream position p
    uint64_t x = (uint64_t)v << (56 - (p & 31));
    w[(size_t)(p >> 5)] |= (uint32_t)(x >> 32);
    w[(size_t)(p >> 5) + 1] |= (uint32_t)x;
  }
  void ones_from_lsb(int64_t p, int nwords) {
    int64_t nbits = (int64_t)nwords * 32;
    if (p >= nbits) return;
    w[(size_t)(p >> 5)] |= ~(((uint32_t)1 << (p & 31)) - 1);
    for (int64_t k = (p >> 5) + 1; k < nwords; k++) w[(size_t)k] = ~0u;
  }
  void ones_from_msb(int64_t p, int nwords) {
    int64_t nbits = (int64_t)nwords * 32;
    if (p >= nbits) return;
    w[(size_t)(p >> 5)] |= ((uint64_t)1 << (32 - (p & 31))) - 1;
    for (int64_t k = (p >> 5) + 1; k < nwords; k++) w[(size_t)k] = ~0u;
  }
  void store(uint32_t* out, int nwords, int B, int lane) const {
    for (int k = 0; k < nwords; k++) out[(size_t)k * B + lane] = w[k];
  }
};

}  // namespace

extern "C" {

// segs concatenated in `data`; segment i is data[offs[i]..offs[i+1]).
// Caller zero-fills the three output matrices.
int grok_ht_dec_prepass(const uint8_t* data, const int64_t* offs,
                        const int32_t* lcups, const int32_t* scups, int B,
                        int wm_mel, int wm_vlc, int wm_ms,
                        uint32_t* out_mel, uint32_t* out_vlc,
                        uint32_t* out_ms) {
  LaneBuf buf;
  for (int i = 0; i < B; i++) {
    const uint8_t* seg = data + offs[i];
    const int lcup = lcups[i], scup = scups[i];

    // ---- MEL: forward from lcup-scup, MSB deposit, 0xFF pad, last
    // real byte's low nibble forced to 0xF ----
    buf.reset(wm_mel);
    {
      const uint8_t* p = seg + (lcup - scup);
      const int n = scup - 1;
      int64_t pos = 0;
      bool unstuff = false;
      const int64_t nbits = (int64_t)wm_mel * 32;
      for (int j = 0; j < n && pos < nbits; j++) {
        unsigned d = p[j];
        if (j == n - 1) d |= 0xF;
        int dbits = unstuff ? 7 : 8;
        buf.or_msb_byte(pos - (8 - dbits), d);  // j=0: dbits=8, start 0
        pos += dbits;
        unstuff = d == 0xFF;
      }
      buf.ones_from_msb(pos < 0 ? 0 : pos, wm_mel);
      buf.store(out_mel, wm_mel, B, i);
    }

    // ---- VLC: initial high nibble of seg[lcup-2] (4 bits, 3 when its
    // low 3 bits are 111), then bytes BACKWARD from lcup-3; zero pad ----
    buf.reset(wm_vlc);
    {
      const unsigned d0 = seg[lcup - 2];
      const unsigned nib = d0 >> 4;
      int64_t pos = 0;
      buf.or_lsb_byte(0, nib);
      pos += 4 - (((nib & 7) == 7) ? 1 : 0);
      bool unstuff = (d0 | 0xF) > 0x8F;
      const int n = scup - 2;
      const int64_t nbits = (int64_t)wm_vlc * 32;
      for (int j = 0; j < n && pos < nbits; j++) {
        unsigned d = seg[lcup - 3 - j];
        int dbits = (unstuff && (d & 0x7F) == 0x7F) ? 7 : 8;
        buf.or_lsb_byte(pos, d);
        pos += dbits;
        unstuff = d > 0x8F;
      }
      buf.store(out_vlc, wm_vlc, B, i);
    }

    // ---- MagSgn: forward bytes 0..lcup-scup, LSB deposit, 0xFF pad ----
    buf.reset(wm_ms);
    {
      const int n = lcup - scup;
      int64_t pos = 0;
      bool unstuff = false;
      const int64_t nbits = (int64_t)wm_ms * 32;
      for (int j = 0; j < n && pos < nbits; j++) {
        unsigned d = seg[j];
        int dbits = unstuff ? 7 : 8;
        buf.or_lsb_byte(pos, d);
        pos += dbits;
        unstuff = d == 0xFF;
      }
      buf.ones_from_lsb(pos < 0 ? 0 : pos, wm_ms);
      buf.store(out_ms, wm_ms, B, i);
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// SigProp / MagRef refinement passes (Part 15 "full" mode)
//
// The cleanup pass codes magnitudes down to plane p; the optional
// refinement segment carries a SigProp pass (new significance at plane
// p-1: raw bits in forward byte order from the segment start) and a
// MagRef pass (one magnitude bit at plane p-1 for each
// cleanup-significant sample: raw bits in BACKWARD byte order from the
// segment end).  Pass semantics and the raw-stream stuffing rules are
// derived from the reference's full decoder (reference:
// src/lib/jp2/t1/t1_ht/coding/ojph_block_decoder.cpp:720-1742, sigprop
// fetch/advance at :1330-1447, magref at :1203-1265); the encoder side
// is original — the reference ships NO refinement encoder and its
// wrapper always passes lengths2=0 (T1HT.cpp:165).  The implementation
// here is a clean scalar stripe walk over explicit significance maps
// rather than the reference's interleaved bit-parallel pipeline; the
// two agree bit-for-bit (tests/test_ht_refinement.py drives the
// reference decoder directly via libgrok.so as the oracle).
// ---------------------------------------------------------------------------

namespace {

// Forward raw bit stream (SigProp): bits are consumed LSB-first within
// bytes; a byte that follows an 0xFF byte carries only 7 payload bits
// (its MSB must be emitted as 0 and is skipped by the reader).
struct SppReader {
  const uint8_t* d;
  int size, pos = 0, nbits = 0;
  uint32_t acc = 0;
  uint8_t prev = 0;
  SppReader(const uint8_t* d_, int n) : d(d_), size(n) {}
  inline int next() {
    if (nbits == 0) {
      uint8_t b = pos < size ? d[pos] : 0;
      pos++;
      nbits = (prev == 0xFF) ? 7 : 8;
      acc = b;
      prev = b;
    }
    int bit = acc & 1;
    acc >>= 1;
    nbits--;
    return bit;
  }
};

struct SppWriter {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int n = 0;
  inline void put(int bit) {
    acc |= (uint32_t)(bit & 1) << n;
    n++;
    int cap = (!out.empty() && out.back() == 0xFF) ? 7 : 8;
    if (n == cap) {
      out.push_back((uint8_t)acc);
      acc = 0;
      n = 0;
    }
  }
  void flush() {
    if (n) {
      out.push_back((uint8_t)acc);
      acc = 0;
      n = 0;
    }
  }
};

// Backward raw bit stream (MagRef): bytes are consumed from the segment
// end toward the front, LSB-first within each byte; a byte whose low 7
// bits are all ones carries only 7 payload bits when the previously
// consumed byte (higher address) was > 0x8F — the reader treats the
// stream start as if that condition held (initial unstuff state).
struct MrpReader {
  const uint8_t* d;
  int size, k = 0, nbits = 0;
  uint32_t acc = 0;
  uint8_t prev = 0;
  bool first = true;
  MrpReader(const uint8_t* d_, int n) : d(d_), size(n) {}
  inline int next() {
    if (nbits == 0) {
      uint8_t b = (k < size) ? d[size - 1 - k] : 0;
      k++;
      bool unstuff = first ? true : (prev > 0x8F);
      nbits = (unstuff && ((b & 0x7F) == 0x7F)) ? 7 : 8;
      acc = b;
      prev = b;
      first = false;
    }
    int bit = acc & 1;
    acc >>= 1;
    nbits--;
    return bit;
  }
};

struct MrpWriter {
  std::vector<uint8_t> bytes;  // in consumption order; caller reverses
  uint32_t acc = 0;
  int n = 0;
  uint8_t prev = 0;
  bool first = true;
  inline void close_byte() {
    bytes.push_back((uint8_t)acc);
    prev = (uint8_t)acc;
    first = false;
    acc = 0;
    n = 0;
  }
  inline void put(int bit) {
    acc |= (uint32_t)(bit & 1) << n;
    n++;
    bool unstuff = first ? true : (prev > 0x8F);
    if (n == 7 && unstuff && (acc & 0x7F) == 0x7F)
      close_byte();  // reader will drop the (zero) MSB
    else if (n == 8)
      close_byte();
  }
  void flush() {
    if (n) close_byte();
  }
};

// SigProp stripe walk shared by encoder and decoder so the candidate
// schedule can never diverge.  `sig_bit(x, y)` consumes/produces the
// significance bit for a candidate and returns it; `sign_bit(x, y)`
// consumes/produces the sign of a newly significant sample.  Candidate
// rules (mirroring the reference decoder's mbr maintenance):
//  - processed in 4-row stripes, 4-column groups, column-major inside a
//    group (col x rows 0..3, then col x+1, ...);
//  - a candidate is an (insignificant after cleanup, not yet refined)
//    sample with a significant 8-neighbor, where neighbor significance
//    means: cleanup significance anywhere in the current stripe or the
//    top row of the stripe below, FINAL (cleanup | new) significance in
//    the bottom row of the stripe above, and new significance from
//    samples earlier in this pass's scan order;
//  - all of a group's significance bits precede its sign bits.
template <class SigBit, class SignBit>
static void sigprop_walk(int w, int h, const uint8_t* sigma, uint8_t* nsig,
                         SigBit&& sig_bit, SignBit&& sign_bit) {
  // Stripe-local state covers all 4 rows even in a partial last stripe:
  // in-pass propagation can reach rows beyond the block (the reference
  // masks its initial mbr with the row pattern but propagates new
  // significance unmasked, so such "phantom" candidates still consume a
  // significance bit — ojph_block_decoder.cpp:1447 region).  A
  // well-formed encoder (ours included) always codes 0 there; the
  // sample itself is never materialized.
  std::vector<uint8_t> mbr((size_t)w * 4);
  std::vector<uint8_t> lnew((size_t)w * 4);
  auto SIG = [&](int x, int y) -> int { return sigma[(size_t)y * w + x]; };
  for (int y0 = 0; y0 < h; y0 += 4) {
    int rows = (h - y0) < 4 ? (h - y0) : 4;
    auto sig_at = [&](int x, int r) -> int {
      return r < rows ? SIG(x, y0 + r) : 0;
    };
    // initial mbr: dilate significance into the stripe's real rows
    std::fill(mbr.begin(), mbr.end(), 0);
    std::fill(lnew.begin(), lnew.end(), 0);
    for (int r = 0; r < rows; r++) {
      int y = y0 + r;
      for (int x = 0; x < w; x++) {
        if (SIG(x, y)) continue;
        int m = 0;
        for (int dy = -1; dy <= 1 && !m; dy++) {
          int ny = y + dy;
          if (ny < 0 || ny >= h) continue;
          for (int dx = -1; dx <= 1; dx++) {
            int nx = x + dx;
            if (nx < 0 || nx >= w || (dx == 0 && dy == 0)) continue;
            if (ny >= y0 - 1 && ny < y0 + 5) {
              int sg = SIG(nx, ny);
              if (ny == y0 - 1)  // above: final state of previous stripe
                sg |= nsig[(size_t)ny * w + nx];
              if (sg) {
                m = 1;
                break;
              }
            }
          }
        }
        mbr[(size_t)r * w + x] = (uint8_t)m;
      }
    }
    // walk 4-column groups (candidates exist on real rows only: the
    // reference masks both the initial mbr and in-pass propagation
    // with the stripe's row pattern — ojph_block_decoder.cpp:1633)
    for (int g0 = 0; g0 < w; g0 += 4) {
      int gend = (g0 + 4) < w ? (g0 + 4) : w;
      int newly[16], nnew = 0;
      for (int x = g0; x < gend; x++) {
        for (int r = 0; r < rows; r++) {
          size_t i = (size_t)r * w + x;
          if (!mbr[i] || sig_at(x, r) || lnew[i]) continue;
          int bit = sig_bit(x, y0 + r, true);
          if (bit) {
            lnew[i] = 1;
            nsig[(size_t)(y0 + r) * w + x] = 1;
            newly[nnew++] = r * w + x;
            // forward-only propagation: same column next row, next
            // column rows r-1..r+1 (clipped to real rows)
            if (r + 1 < rows && !sig_at(x, r + 1)) mbr[i + w] = 1;
            if (x + 1 < w) {
              if (r > 0 && !sig_at(x + 1, r - 1)) mbr[i - w + 1] = 1;
              if (!sig_at(x + 1, r)) mbr[i + 1] = 1;
              if (r + 1 < rows && !sig_at(x + 1, r + 1)) mbr[i + w + 1] = 1;
            }
          }
        }
      }
      for (int k = 0; k < nnew; k++) {
        int x = newly[k] % w, r = newly[k] / w;
        sign_bit(x, y0 + r, true);
      }
    }
  }
}

// MagRef sample order: stripe of 4 rows, column-major (col x rows 0..3)
// over cleanup-significant samples; one raw bit each.
template <class Fn>
static void magref_walk(int w, int h, const uint8_t* sigma, Fn&& fn) {
  for (int y0 = 0; y0 < h; y0 += 4) {
    int rows = (h - y0) < 4 ? (h - y0) : 4;
    for (int x = 0; x < w; x++)
      for (int r = 0; r < rows; r++)
        if (sigma[(size_t)(y0 + r) * w + x]) fn(x, y0 + r);
  }
}

}  // namespace

extern "C" {

// Encode cleanup at one plane up (mu = mag >> 1, Mb-1 planes) plus a
// refinement segment carrying SigProp (and, with passes >= 3, MagRef)
// for the dropped plane.  Writes [cleanup | refinement] into out_buf,
// returns 0 and the segment lengths in len1/len2, or -1 on overflow.
// Note: refinement is inherently lossy-scalable — a mag==1 sample with
// no significant neighbor has no candidate slot in SigProp and decodes
// to 0 (the same stream any Part-15 full-mode decoder reconstructs).
int grok_ht_encode_refined(const uint32_t* mag, const uint8_t* neg, int w,
                           int h, int Mb, int passes, uint8_t* out_buf,
                           int out_cap, int* len1, int* len2) {
  if (Mb < 2 || passes < 2 || passes > 3) return -1;
  size_t wh = (size_t)w * h;
  std::vector<uint32_t> mu(wh);
  std::vector<uint8_t> sigma(wh);
  for (size_t i = 0; i < wh; i++) {
    mu[i] = mag[i] >> 1;
    sigma[i] = mu[i] != 0;
  }
  std::vector<uint8_t> cup(wh * 6 + 64);
  int l1 = ht_encode(mu.data(), neg, w, h, Mb - 1, cup.data());
  if (l1 < 0) return -1;

  SppWriter spp;
  std::vector<uint8_t> nsig(wh, 0);
  sigprop_walk(
      w, h, sigma.data(), nsig.data(),
      [&](int x, int y, bool real) {
        // plane p-1 bit; mu == 0 here.  Phantom slots always code 0.
        int bit = real ? (int)(mag[(size_t)y * w + x] & 1) : 0;
        spp.put(bit);
        return bit;
      },
      [&](int x, int y, bool real) {
        spp.put(real && neg[(size_t)y * w + x] ? 1 : 0);
      });
  spp.flush();

  MrpWriter mrp;
  if (passes >= 3) {
    magref_walk(w, h, sigma.data(), [&](int x, int y) {
      mrp.put((int)(mag[(size_t)y * w + x] & 1));
    });
    mrp.flush();
  }

  int l2 = (int)(spp.out.size() + mrp.bytes.size());
  if (l1 + l2 > out_cap) return -1;
  std::memcpy(out_buf, cup.data(), (size_t)l1);
  std::memcpy(out_buf + l1, spp.out.data(), spp.out.size());
  uint8_t* mrp_dst = out_buf + l1 + spp.out.size();
  for (size_t i = 0; i < mrp.bytes.size(); i++)  // backward stream
    mrp_dst[mrp.bytes.size() - 1 - i] = mrp.bytes[i];
  *len1 = l1;
  *len2 = l2;
  return 0;
}

// Decode cleanup + refinement.  Magnitudes are returned in QUARTER
// units of the cleanup plane (exact integers, no implicit half):
//   cleanup-significant: 4*mu + 2            (2 passes)
//                        4*mu + 2*bit + 1    (3 passes)
//   SigProp-new:         3
// mirroring the reference's fixed-point reconstruction
// ((v+2)<<(p-1) -> bit p-1 toggled by MagRef, bin center at p-2;
// reference: ojph_block_decoder.cpp:1226,1352).  Callers scale:
// reversible full decode uses q >> 1 (= 2*mu + bit), irreversible uses
// q * (delta/4).  Mb is the plane count of the ORIGINAL magnitudes (the
// cleanup segment itself carries Mb-1 planes, matching
// grok_ht_encode_refined).
int grok_ht_decode_refined(const uint8_t* data, int len1, int len2,
                           int passes, int w, int h, int Mb,
                           uint32_t* quarters, uint8_t* neg) {
  size_t wh = (size_t)w * h;
  std::memset(quarters, 0, wh * sizeof(uint32_t));
  std::memset(neg, 0, wh);
  if (!ht_decode(data, len1, w, h, Mb - 1, quarters, neg)) return -1;
  std::vector<uint8_t> sigma(wh);
  for (size_t i = 0; i < wh; i++) {
    sigma[i] = quarters[i] != 0;
    if (sigma[i]) quarters[i] = 4 * quarters[i] + 2;
  }
  if (passes >= 2 && len2 > 0) {
    SppReader spp(data + len1, len2);
    std::vector<uint8_t> nsig(wh, 0);
    sigprop_walk(
        w, h, sigma.data(), nsig.data(),
        [&](int x, int y, bool real) {
          int bit = spp.next();
          if (bit && real) quarters[(size_t)y * w + x] = 3;
          return bit;
        },
        [&](int x, int y, bool real) {
          int sg = spp.next();
          if (real) neg[(size_t)y * w + x] = (uint8_t)sg;
        });
  }
  if (passes >= 3 && len2 > 0) {
    MrpReader mrp(data + len1, len2);
    magref_walk(w, h, sigma.data(), [&](int x, int y) {
      int bit = mrp.next();
      size_t i = (size_t)y * w + x;
      quarters[i] = (quarters[i] - 2) + 2 * (uint32_t)bit + 1;
    });
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Refined band-plane batch entries (worker threads over code-blocks)
// ---------------------------------------------------------------------------

extern "C" {

// Encode code-blocks gathered out of band planes, each as the refined
// pair [cleanup | refinement] of grok_ht_encode_refined at `passes`, or,
// where its band's Mb is below 2, as one plain cleanup segment
// (ht_encode at Mb). Each worker gathers its block into thread-local
// (mag, neg) buffers: |v| and v < 0 from int32 planes, or from float32
// planes the deadzone quantizer floor(|v| / step) in double (the
// extract path's rule, grok_extract_blocks_f32), then codes it into its
// output slot.
// desc5 per block (int64): [band_idx, x0, y0, w, h]; mbs: per-block band
// Mb. out_len1 / out_len2: the segments' lengths (out_len2 0 for a plain
// block). Returns 0, or -1 when a block overflows out_stride.
int grok_ht_encode_refined_bands(int nblocks, const int64_t* band_ptrs,
                                 const int64_t* band_strides,
                                 const double* steps, int is_float,
                                 const int64_t* desc5, const int64_t* mbs,
                                 int passes, uint8_t* out_flat,
                                 int out_stride, int32_t* out_len1,
                                 int32_t* out_len2, int nthreads) {
  std::atomic<int> err(0);
  parallel_for(nblocks, nthreads, [&](int i) {
    const int64_t* d = desc5 + (size_t)i * 5;
    int w = (int)d[3], h = (int)d[4], mb = (int)mbs[i];
    int64_t stride = band_strides[d[0]];
    static thread_local std::vector<uint32_t> mag;
    static thread_local std::vector<uint8_t> neg;
    mag.resize((size_t)w * h);
    neg.resize((size_t)w * h);
    for (int y = 0; y < h; y++) {
      uint32_t* mo = mag.data() + (size_t)y * w;
      uint8_t* no = neg.data() + (size_t)y * w;
      if (is_float) {
        const float* src = (const float*)(uintptr_t)band_ptrs[d[0]]
            + (size_t)(d[2] + y) * stride + d[1];
        double step = steps[d[0]];
        for (int x = 0; x < w; x++) {
          float v = src[x];
          mo[x] = (uint32_t)((double)(v < 0 ? -v : v) / step);
          no[x] = v < 0;
        }
      } else {
        const int32_t* src = (const int32_t*)(uintptr_t)band_ptrs[d[0]]
            + (size_t)(d[2] + y) * stride + d[1];
        for (int x = 0; x < w; x++) {
          int64_t v = src[x];
          mo[x] = (uint32_t)(v < 0 ? -v : v);
          no[x] = v < 0;
        }
      }
    }
    uint8_t* out = out_flat + (size_t)i * out_stride;
    if (mb < 2) {
      // out_stride >= 6*w*h + 64 (the caller's bound): the plain coder
      // writes in place
      out_len1[i] = ht_encode(mag.data(), neg.data(), w, h, mb, out);
      out_len2[i] = 0;
      if (out_len1[i] > out_stride) err.store(1);
      return;
    }
    int l1 = 0, l2 = 0;
    if (grok_ht_encode_refined(mag.data(), neg.data(), w, h, mb, passes,
                               out, out_stride, &l1, &l2) != 0) {
      err.store(1);
      return;
    }
    out_len1[i] = l1;
    out_len2[i] = l2;
  });
  return err.load() ? -1 : 0;
}

// Decode refined code-blocks straight into band planes: each block's
// cleanup + refinement (grok_ht_decode_refined) into thread-local
// quarter magnitudes, then q >> 1 (the band's quantizer units) scattered
// into its rectangle with the sign, int32, or float32 with the mid-point
// dequantizer (SinkF32). A block whose cleanup does not decode is left
// zero.
// desc per block (int64 x 10): [0]=data offset, [1]=len1, [2]=len2,
//   [3]=passes, [4]=w, [5]=h, [6]=Mb, [7]=band index, [8]=x0, [9]=y0
int grok_ht_decode_refined_bands(int nblocks, const uint8_t* data_flat,
                                 const int64_t* desc,
                                 const int64_t* band_ptrs,
                                 const int64_t* band_strides,
                                 const double* steps, int is_float,
                                 int nthreads) {
  parallel_for(nblocks, nthreads, [&](int i) {
    const int64_t* d = desc + (size_t)i * 10;
    int w = (int)d[4], h = (int)d[5];
    static thread_local std::vector<uint32_t> q;
    static thread_local std::vector<uint8_t> neg;
    q.resize((size_t)w * h);
    neg.resize((size_t)w * h);
    if (grok_ht_decode_refined(data_flat + d[0], (int)d[1], (int)d[2],
                               (int)d[3], w, h, (int)d[6], q.data(),
                               neg.data()) != 0)
      return;
    int64_t stride = band_strides[d[7]];
    if (is_float) {
      SinkF32 sink{(float*)(uintptr_t)band_ptrs[d[7]]
                       + (size_t)d[9] * stride + d[8],
                   stride, (float)steps[d[7]]};
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
          sink.write(x, y, q[(size_t)y * w + x] >> 1, neg[(size_t)y * w + x]);
    } else {
      SinkI32 sink{(int32_t*)(uintptr_t)band_ptrs[d[7]]
                       + (size_t)d[9] * stride + d[8],
                   stride};
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
          sink.write(x, y, q[(size_t)y * w + x] >> 1, neg[(size_t)y * w + x]);
    }
  });
  return 0;
}

}  // extern "C"
