// EBCOT Tier-1 with the MQ coder of the port's host library: the Part-1
// code-block coder for every code-block style (BYPASS, RESET, TERMALL,
// VSC, PTERM, SEGMARK), the route of the code-blocks the CUDA MQ kernels
// do not code. A copy of grokimagecompression_tpu/native/src/t1.cpp (its
// MQ half; the HT coder there is not copied). The batch entry points take
// their worker count from the caller and run on std::thread workers that
// take code-blocks from one atomic counter (the original's OpenMP loops;
// the port's host library builds without OpenMP). Each block writes only
// its own output slot, so the output does not depend on the thread count.
// Built with g++ (ops/_build.host_library).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// MQ coder (Annex C)
// ---------------------------------------------------------------------------

struct MQEntry { uint16_t qe; uint8_t nmps, nlps, sw; };

static const MQEntry MQ_TABLE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

constexpr int NUM_CTXS = 19;
constexpr int CTX_ZC = 0;
constexpr int CTX_SC = 9;
constexpr int CTX_MAG = 14;
constexpr int CTX_RL = 17;
constexpr int CTX_UNI = 18;

struct CtxState { uint8_t state, mps; };

static void init_states(CtxState* ctx) {
  for (int i = 0; i < NUM_CTXS; i++) { ctx[i].state = 0; ctx[i].mps = 0; }
  ctx[CTX_ZC].state = 4;
  ctx[CTX_RL].state = 3;
  ctx[CTX_UNI].state = 46;
}

struct MQEncoder {
  uint32_t a = 0x8000, c = 0;
  int ct = 12;
  std::vector<uint8_t> out;
  CtxState* ctx;  // shared, persists across segments

  explicit MQEncoder(CtxState* shared) : ctx(shared) { out.reserve(4096); }

  void restart() { a = 0x8000; c = 0; ct = 12; out.clear(); }

  void byteout() {
    if (!out.empty() && out.back() == 0xFF) {
      out.push_back((c >> 20) & 0xFF);
      c &= 0xFFFFF;
      ct = 7;
    } else {
      if (c > 0x7FFFFFF) {
        if (!out.empty()) {
          out.back() += 1;
          if (out.back() == 0xFF) {
            c &= 0x7FFFFFF;
            out.push_back((c >> 20) & 0xFF);
            c &= 0xFFFFF;
            ct = 7;
            return;
          }
        }
        c &= 0x7FFFFFF;
      }
      out.push_back((c >> 19) & 0xFF);
      c &= 0x7FFFF;
      ct = 8;
    }
  }

  inline void renorm() {
    // Batched renormalization: shift by the full deficit at once
    // instead of bit-by-bit (a is nonzero 16-bit here, so the deficit
    // is clz(a)-16). byteout() fires exactly where the per-bit loop
    // would, preserving byte-identical output.
    int s = __builtin_clz(a) - 16;
    while (s >= ct) {
      a = (a << ct) & 0xFFFF;
      c <<= ct;
      s -= ct;
      ct = 0;
      byteout();
    }
    if (s) {
      a = (a << s) & 0xFFFF;
      c <<= s;
      ct -= s;
      if (ct == 0) byteout();
    }
  }

  void encode(int d, int cx) {
    CtxState& s = ctx[cx];
    uint32_t qe = MQ_TABLE[s.state].qe;
    a -= qe;
    if (d == s.mps) {
      if (a & 0x8000) {
        c += qe;
      } else {
        if (a < qe) a = qe; else c += qe;
        s.state = MQ_TABLE[s.state].nmps;
        renorm();
      }
    } else {
      if (a < qe) c += qe; else a = qe;
      if (MQ_TABLE[s.state].sw) s.mps = 1 - s.mps;
      s.state = MQ_TABLE[s.state].nlps;
      renorm();
    }
  }

  // FLUSH (C.3.4); appends terminated bytes to `dst`.
  void flush_into(std::vector<uint8_t>& dst) {
    uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (!out.empty() && out.back() == 0xFF) out.pop_back();
    dst.insert(dst.end(), out.begin(), out.end());
  }

  // Predictable termination (PTERM; reference: mqc_enc.cpp
  // mqc_erterm_enc).
  void erterm_into(std::vector<uint8_t>& dst) {
    int k = 11 - ct + 1;
    while (k > 0) {
      c <<= ct;
      ct = 0;
      byteout();
      k -= ct;
    }
    if (out.empty() || out.back() != 0xFF) byteout();
    dst.insert(dst.end(), out.begin(), out.end());
  }
};

struct MQDecoder {
  uint32_t a = 0, c = 0;
  int ct = 0;
  const uint8_t* data;
  size_t pos = 0, end;
  CtxState* ctx;

  MQDecoder(const uint8_t* d, size_t n, CtxState* shared)
      : data(d), end(n), ctx(shared) {
    c = (end == 0) ? (0xFFu << 16) : ((uint32_t)data[0] << 16);
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }

  void bytein() {
    if (pos < end) {
      uint32_t nxt = (pos + 1 < end) ? data[pos + 1] : 0xFF;
      if (data[pos] == 0xFF) {
        if (nxt > 0x8F) {
          c += 0xFF00;
          ct = 8;
        } else {
          pos += 1;
          c += nxt << 9;
          ct = 7;
        }
      } else {
        pos += 1;
        c += nxt << 8;
        ct = 8;
      }
    } else {
      c += 0xFF00;
      ct = 8;
    }
  }

  inline void renormd() {
    // Batched renormalization (see MQEncoder::renorm): same bytein
    // points and dropped high bits as the per-bit loop.
    int s = __builtin_clz(a) - 16;
    while (s > 0) {
      if (ct == 0) bytein();
      int t = s < ct ? s : ct;
      a = (a << t) & 0xFFFF;
      c = (c << t);
      ct -= t;
      s -= t;
    }
  }

  int decode(int cx) {
    CtxState& s = ctx[cx];
    uint32_t qe = MQ_TABLE[s.state].qe;
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = s.mps;
        s.state = MQ_TABLE[s.state].nmps;
      } else {
        d = 1 - s.mps;
        if (MQ_TABLE[s.state].sw) s.mps = 1 - s.mps;
        s.state = MQ_TABLE[s.state].nlps;
      }
      a = qe;
      renormd();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - s.mps;
          if (MQ_TABLE[s.state].sw) s.mps = 1 - s.mps;
          s.state = MQ_TABLE[s.state].nlps;
        } else {
          d = s.mps;
          s.state = MQ_TABLE[s.state].nmps;
        }
        renormd();
      } else {
        d = s.mps;
      }
    }
    return d;
  }
};

struct RawEncoder {
  std::vector<uint8_t> out;
  uint32_t c = 0;
  int ct = 8;

  void encode(int d) {
    c = (c << 1) | (d & 1);
    if (--ct == 0) {
      out.push_back((uint8_t)c);
      ct = (c == 0xFF) ? 7 : 8;
      c = 0;
    }
  }

  void flush_into(std::vector<uint8_t>& dst, bool erterm = false) {
    // Pad the partial byte with alternating 0,1,... (the reference's
    // bypass flush does this unconditionally, mqc_bypass_flush_enc);
    // PTERM additionally forces emission after a stuffed 0xFF.
    int full_ct = (!out.empty() && out.back() == 0xFF) ? 7 : 8;
    if (ct < full_ct || (erterm && ct == 7)) {
      uint32_t cc = c;
      int cnt = ct, bit = 0;
      while (cnt > 0) {
        cnt--;
        cc = (cc << 1) | bit;
        bit = 1 - bit;
      }
      out.push_back((uint8_t)(cc & 0xFF));
    }
    dst.insert(dst.end(), out.begin(), out.end());
  }
};

struct RawDecoder {
  const uint8_t* data;
  size_t pos = 0, end;
  uint32_t c = 0;
  int ct = 0;

  RawDecoder(const uint8_t* d, size_t n) : data(d), end(n) {}

  int decode() {
    if (ct == 0) {
      if (pos < end) {
        bool prev_ff = pos > 0 && data[pos - 1] == 0xFF;
        c = data[pos++];
        ct = prev_ff ? 7 : 8;
        if (prev_ff) c &= 0x7F;
      } else {
        c = 0xFF;
        ct = 8;
      }
    }
    ct -= 1;
    return (c >> ct) & 1;
  }
};

// ---------------------------------------------------------------------------
// T1 block coder (Annex D)
// ---------------------------------------------------------------------------

constexpr int CBLKSTY_LAZY = 0x01;
constexpr int CBLKSTY_RESET = 0x02;
constexpr int CBLKSTY_TERMALL = 0x04;
constexpr int CBLKSTY_VSC = 0x08;
constexpr int CBLKSTY_PTERM = 0x10;
constexpr int CBLKSTY_SEGSYM = 0x20;

constexpr int PASS_SIG = 0, PASS_REF = 1, PASS_CLN = 2;

// Zero-coding context (Table D.1).
static int zc_context(int h, int v, int d, int orient) {
  if (orient == 1) { int t = h; h = v; v = t; }
  if (orient == 3) {
    if (d >= 3) return 8;
    if (d == 2) return (h + v >= 1) ? 7 : 6;
    if (d == 1) {
      int hv = h + v;
      return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
    }
    int hv = h + v;
    return hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
  }
  if (h == 2) return 8;
  if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
  if (v == 2) return 4;
  if (v == 1) return 3;
  return d >= 2 ? 2 : (d == 1 ? 1 : 0);
}

// Sign-coding contexts (Table D.2), indexed by (hc+1)*3 + (vc+1).
static const int SC_OFF[9] = {4, 3, 2, 1, 0, 1, 2, 3, 4};
static const int SC_SPB[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};
// (hc,vc): (-1,-1)->(4,1) (-1,0)->(3,1) (-1,1)->(2,1)
//          (0,-1)->(1,1)  (0,0)->(0,0)  (0,1)->(1,0)
//          (1,-1)->(2,0)  (1,0)->(3,0)  (1,1)->(4,0)
static const int SC_OFF2[9] = {4, 3, 2, 1, 0, 1, 2, 3, 4};
static const int SC_SPB2[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

// Per-sample neighborhood word, updated incrementally when a sample turns
// significant (the reference keeps equivalent packed flags, t1_flags.h —
// reimplemented here as a padded (h+2)x(w+2) plane so border tests vanish):
//   bits 0-1: horizontal significant-neighbor count (0..2)
//   bits 2-3: vertical count (0..2)
//   bits 4-6: diagonal count (0..4)
// ZC context comes from a 512-entry LUT per orientation.
struct BlockState {
  int w, h, orient, stride;
  bool vsc;
  std::vector<uint16_t> nbh;   // padded (h+2) x (w+2)
  // Per-sample state packed into one byte: 1 load on the pass skip
  // tests instead of three separate arrays.
  static constexpr uint8_t F_SIG = 1, F_VIS = 2, F_REF = 4;
  std::vector<uint8_t> flags, neg;  // w*h

  BlockState(int w_, int h_, int orient_, bool vsc_ = false)
      : w(w_), h(h_), orient(orient_), stride(w_ + 2), vsc(vsc_),
        nbh((w_ + 2) * (h_ + 2), 0),
        flags(w_ * h_, 0), neg(w_ * h_, 0) {}

  inline void clear_visited() {
    uint8_t* f = flags.data();
    size_t n = flags.size();
    for (size_t i = 0; i < n; i++) f[i] &= (uint8_t)~F_VIS;
  }

  inline int idx(int x, int y) const { return y * w + x; }
  inline int pidx(int x, int y) const { return (y + 1) * stride + (x + 1); }

  inline void set_sig(int x, int y) {
    flags[idx(x, y)] |= F_SIG;
    uint16_t* p = &nbh[pidx(x, y)];
    p[-1] += 1;            // left:   horizontal count
    p[+1] += 1;            // right
    // VSC (stripe-causal): a stripe's first row does not propagate into
    // the stripe above (so the row above never sees it as significant).
    bool up_ok = !(vsc && (y & 3) == 0);
    if (up_ok) {
      p[-stride] += 4;     // up:     vertical count (bit 2)
      p[-stride - 1] += 16;
      p[-stride + 1] += 16;
    }
    p[+stride] += 4;       // down
    p[+stride - 1] += 16;  // diagonals (bit 4)
    p[+stride + 1] += 16;
  }

  inline int zc_ctx_of(uint16_t nb) const;

  inline int zc_ctx(int x, int y) const { return zc_ctx_of(nbh[pidx(x, y)]); }

  inline bool has_sig_nbr(int x, int y) const { return nbh[pidx(x, y)] != 0; }

  inline void sc_ctx(int x, int y, int& cx, int& spb) const {
    auto contrib = [&](int xx, int yy) -> int {
      if (xx < 0 || xx >= w || yy < 0 || yy >= h) return 0;
      if (!(flags[idx(xx, yy)] & F_SIG)) return 0;
      return neg[idx(xx, yy)] ? -1 : 1;
    };
    int hc = contrib(x - 1, y) + contrib(x + 1, y);
    if (hc > 1) hc = 1;
    if (hc < -1) hc = -1;
    int below = (vsc && (y & 3) == 3) ? 0 : contrib(x, y + 1);
    int vc = contrib(x, y - 1) + below;
    if (vc > 1) vc = 1;
    if (vc < -1) vc = -1;
    int k = (hc + 1) * 3 + (vc + 1);
    cx = CTX_SC + SC_OFF2[k];
    spb = SC_SPB2[k];
  }

  inline int mag_ctx(int x, int y) const {
    if (flags[idx(x, y)] & F_REF) return CTX_MAG + 2;
    return CTX_MAG + (has_sig_nbr(x, y) ? 1 : 0);
  }
};

// ZC LUT: index = nbh word truncated to 7 bits (h:2, v:2, d:3), per orient.
struct ZcLut {
  uint8_t lut[4][128];
  ZcLut() {
    for (int orient = 0; orient < 4; orient++)
      for (int word = 0; word < 128; word++) {
        int hh = word & 3;
        int vv = (word >> 2) & 3;
        int dd = (word >> 4) & 7;
        if (hh > 2) hh = 2;
        if (vv > 2) vv = 2;
        if (dd > 4) dd = 4;
        lut[orient][word] = (uint8_t)(CTX_ZC + zc_context(hh, vv, dd, orient));
      }
  }
};
static const ZcLut ZC_LUT;

inline int BlockState::zc_ctx_of(uint16_t nb) const {
  return ZC_LUT.lut[orient][nb & 127];
}

static inline bool lazy_boundary(int passno, int ptype) {
  return passno >= 9 && ptype != PASS_SIG;
}

struct PassRec {
  int32_t rate;
  double dist;
  uint8_t terminated;
};

// Returns encoded length, fills meta/pass arrays.
static int encode_cblk(const uint32_t* mag, const uint8_t* negp, int w, int h,
                       int orient, int style, std::vector<uint8_t>& out,
                       int* numbps_out, int* numpasses_out,
                       std::vector<PassRec>& passes) {
  uint32_t maxmag = 0;
  for (int i = 0; i < w * h; i++) maxmag |= mag[i];
  int numbps = 0;
  while ((maxmag >> numbps) != 0) numbps++;
  *numbps_out = numbps;
  *numpasses_out = 0;
  if (numbps == 0) return 0;

  BlockState st(w, h, orient, (style & CBLKSTY_VSC) != 0);
  std::memcpy(st.neg.data(), negp, w * h);

  bool lazy = style & CBLKSTY_LAZY;
  bool termall = style & CBLKSTY_TERMALL;
  bool reset = style & CBLKSTY_RESET;
  bool segsym = style & CBLKSTY_SEGSYM;
  bool pterm = style & CBLKSTY_PTERM;

  CtxState ctx[NUM_CTXS];
  init_states(ctx);
  MQEncoder mq(ctx);
  RawEncoder raw_enc;
  bool using_raw = false;
  double total_dist = 0.0;

  auto bitof = [&](int x, int y, int plane) -> int {
    return (mag[y * w + x] >> plane) & 1;
  };
  auto sig_dist = [&](int x, int y, int plane) -> double {
    double v = (double)mag[y * w + x];
    double half = 1.5 * (double)(1u << plane);
    return v * v - (v - half) * (v - half);
  };
  auto ref_dist = [&](int x, int y, int plane) -> double {
    uint32_t m = mag[y * w + x];
    double v = (double)m;
    double above = (double)((m >> (plane + 1)) << (plane + 1));
    double rb = above + (double)(1u << plane);
    double ra = (double)((m >> plane) << plane) + (double)(1u << plane) * 0.5;
    return (v - rb) * (v - rb) - (v - ra) * (v - ra);
  };
  auto code_sign = [&](int x, int y, bool raw) {
    if (raw) {
      raw_enc.encode(st.neg[st.idx(x, y)]);
    } else {
      int cx, spb;
      st.sc_ctx(x, y, cx, spb);
      mq.encode(st.neg[st.idx(x, y)] ^ spb, cx);
    }
  };

  auto spp = [&](int plane, bool raw) {
    st.clear_visited();
    for (int k = 0; k < h; k += 4) {
      int sh = (h - k < 4) ? h - k : 4;
      for (int x = 0; x < w; x++) {
        for (int y = k; y < k + sh; y++) {
          int i = st.idx(x, y);
          if (st.flags[i] & BlockState::F_SIG) continue;
          if (!st.has_sig_nbr(x, y)) continue;
          int bit = bitof(x, y, plane);
          if (raw) raw_enc.encode(bit); else mq.encode(bit, st.zc_ctx(x, y));
          if (bit) {
            code_sign(x, y, raw);
            st.set_sig(x, y);
            total_dist += sig_dist(x, y, plane);
          }
          st.flags[i] |= BlockState::F_VIS;
        }
      }
    }
  };

  auto mrp = [&](int plane, bool raw) {
    for (int k = 0; k < h; k += 4) {
      int sh = (h - k < 4) ? h - k : 4;
      for (int x = 0; x < w; x++) {
        for (int y = k; y < k + sh; y++) {
          int i = st.idx(x, y);
          if ((st.flags[i] & (BlockState::F_SIG | BlockState::F_VIS))
              != BlockState::F_SIG) continue;
          int bit = bitof(x, y, plane);
          if (raw) raw_enc.encode(bit); else mq.encode(bit, st.mag_ctx(x, y));
          total_dist += ref_dist(x, y, plane);
          st.flags[i] |= BlockState::F_REF;
        }
      }
    }
  };

  auto cp = [&](int plane) {
    for (int k = 0; k < h; k += 4) {
      int sh = (h - k < 4) ? h - k : 4;
      for (int x = 0; x < w; x++) {
        int start = 0;
        if (sh == 4) {
          bool agg = true;
          for (int y = k; y < k + 4; y++) {
            int i = st.idx(x, y);
            if ((st.flags[i] & (BlockState::F_SIG | BlockState::F_VIS))
                || st.has_sig_nbr(x, y)) {
              agg = false;
              break;
            }
          }
          if (agg) {
            int r = -1;
            for (int i2 = 0; i2 < 4; i2++) {
              if (bitof(x, k + i2, plane)) { r = i2; break; }
            }
            if (r < 0) {
              mq.encode(0, CTX_RL);
              continue;
            }
            mq.encode(1, CTX_RL);
            mq.encode((r >> 1) & 1, CTX_UNI);
            mq.encode(r & 1, CTX_UNI);
            int y = k + r;
            code_sign(x, y, false);
            st.set_sig(x, y);
            total_dist += sig_dist(x, y, plane);
            start = r + 1;
          }
        }
        for (int y = k + start; y < k + sh; y++) {
          int i = st.idx(x, y);
          if (st.flags[i] & (BlockState::F_SIG | BlockState::F_VIS))
            continue;
          int bit = bitof(x, y, plane);
          mq.encode(bit, st.zc_ctx(x, y));
          if (bit) {
            code_sign(x, y, false);
            st.set_sig(x, y);
            total_dist += sig_dist(x, y, plane);
          }
        }
      }
    }
    if (segsym) {
      mq.encode(1, CTX_UNI);
      mq.encode(0, CTX_UNI);
      mq.encode(1, CTX_UNI);
      mq.encode(0, CTX_UNI);
    }
  };

  int num_passes_total = 3 * numbps - 2;
  *numpasses_out = num_passes_total;
  passes.clear();
  passes.reserve(num_passes_total);
  int passno = 0;
  bool prev_terminated = false;
  bool ctx_saved = true;  // contexts persist unless reset

  for (int plane = numbps - 1; plane >= 0; plane--) {
    int first = (plane == numbps - 1) ? PASS_CLN : PASS_SIG;
    for (int ptype = first; ptype <= PASS_CLN; ptype++) {
      bool raw = lazy && ptype != PASS_CLN && passno >= 10;
      bool is_last = passno == num_passes_total - 1;
      if (prev_terminated) {
        if (raw) {
          raw_enc = RawEncoder();
          using_raw = true;
        } else {
          mq.restart();
          if (!ctx_saved) init_states(ctx);
          using_raw = false;
        }
        prev_terminated = false;
      }
      (void)using_raw;
      if (ptype == PASS_SIG) spp(plane, raw);
      else if (ptype == PASS_REF) mrp(plane, raw);
      else cp(plane);

      bool terminated = false;
      if (termall || is_last || (lazy && lazy_boundary(passno, ptype))) {
        if (raw) raw_enc.flush_into(out, pterm);
        else {
          // PTERM uses the standard FLUSH (see t1_np.py note).
          mq.flush_into(out);
          ctx_saved = !reset;
        }
        terminated = true;
        prev_terminated = true;
      }
      if (reset && !terminated && !raw) init_states(ctx);
      int32_t rate = (int32_t)out.size();
      if (!terminated) {
        size_t pending = raw ? raw_enc.out.size() : mq.out.size();
        rate += (int32_t)pending + 5;
      }
      passes.push_back({rate, total_dist, (uint8_t)terminated});
      passno++;
    }
  }

  // Rate fix-ups identical to the Python reference.
  int32_t total = (int32_t)out.size();
  for (auto& p : passes) if (p.rate > total) p.rate = total;
  for (int i = (int)passes.size() - 2; i >= 0; i--) {
    if (!passes[i].terminated && passes[i].rate > passes[i + 1].rate)
      passes[i].rate = passes[i + 1].rate;
  }
  for (size_t i = 1; i < passes.size(); i++) {
    if (passes[i].rate < passes[i - 1].rate) passes[i].rate = passes[i - 1].rate;
  }
  if (!passes.empty()) passes.back().rate = total;
  return (int)out.size();
}

static void decode_cblk(const uint8_t* data, int len, const int32_t* seg_lens,
                        int nsegs, int w, int h, int orient, int numbps,
                        int numpasses, int style, uint32_t* mag,
                        uint8_t* neg) {
  std::memset(mag, 0, sizeof(uint32_t) * w * h);
  std::memset(neg, 0, (size_t)w * h);
  if (numpasses == 0 || numbps == 0) return;

  BlockState st(w, h, orient, (style & CBLKSTY_VSC) != 0);
  bool lazy = style & CBLKSTY_LAZY;
  bool termall = style & CBLKSTY_TERMALL;
  bool reset = style & CBLKSTY_RESET;
  bool segsym = style & CBLKSTY_SEGSYM;

  int offset = 0, seg_i = 0;
  auto next_segment = [&](const uint8_t*& p, int& n) {
    if (nsegs <= 0) {
      p = data + offset;
      n = len - offset;
      offset = len;
    } else {
      int ln = seg_lens[seg_i++];
      p = data + offset;
      n = ln;
      offset += ln;
    }
  };

  CtxState ctx[NUM_CTXS];
  init_states(ctx);
  MQDecoder* mqd = nullptr;
  RawDecoder* rawd = nullptr;
  std::vector<uint8_t> mq_store(sizeof(MQDecoder));
  std::vector<uint8_t> raw_store(sizeof(RawDecoder));

  auto get_mq = [&]() -> MQDecoder* {
    if (!mqd) {
      const uint8_t* p; int n;
      next_segment(p, n);
      mqd = new (mq_store.data()) MQDecoder(p, (size_t)n, ctx);
    }
    return mqd;
  };
  auto get_raw = [&]() -> RawDecoder* {
    if (!rawd) {
      const uint8_t* p; int n;
      next_segment(p, n);
      rawd = new (raw_store.data()) RawDecoder(p, (size_t)n);
    }
    return rawd;
  };
  auto end_coder = [&]() {
    if (mqd && reset) init_states(ctx);
    mqd = nullptr;
    rawd = nullptr;
  };

  auto decode_sign = [&](int x, int y, bool raw) -> int {
    if (raw) return rawd->decode();
    int cx, spb;
    st.sc_ctx(x, y, cx, spb);
    return mqd->decode(cx) ^ spb;
  };

  auto spp = [&](int plane, bool raw) {
    st.clear_visited();
    for (int k = 0; k < h; k += 4) {
      int sh = (h - k < 4) ? h - k : 4;
      for (int x = 0; x < w; x++) {
        for (int y = k; y < k + sh; y++) {
          int i = st.idx(x, y);
          if (st.flags[i] & BlockState::F_SIG) continue;
          if (!st.has_sig_nbr(x, y)) continue;
          int bit = raw ? rawd->decode() : mqd->decode(st.zc_ctx(x, y));
          if (bit) {
            int s = decode_sign(x, y, raw);
            st.set_sig(x, y);
            st.neg[i] = (uint8_t)s;
            neg[i] = (uint8_t)s;
            mag[i] |= (1u << plane);
          }
          st.flags[i] |= BlockState::F_VIS;
        }
      }
    }
  };

  auto mrp = [&](int plane, bool raw) {
    for (int k = 0; k < h; k += 4) {
      int sh = (h - k < 4) ? h - k : 4;
      for (int x = 0; x < w; x++) {
        for (int y = k; y < k + sh; y++) {
          int i = st.idx(x, y);
          if ((st.flags[i] & (BlockState::F_SIG | BlockState::F_VIS))
              != BlockState::F_SIG) continue;
          int bit = raw ? rawd->decode() : mqd->decode(st.mag_ctx(x, y));
          if (bit) mag[i] |= (1u << plane);
          st.flags[i] |= BlockState::F_REF;
        }
      }
    }
  };

  auto cp = [&](int plane) {
    for (int k = 0; k < h; k += 4) {
      int sh = (h - k < 4) ? h - k : 4;
      for (int x = 0; x < w; x++) {
        int start = 0;
        if (sh == 4) {
          bool agg = true;
          for (int y = k; y < k + 4; y++) {
            int i = st.idx(x, y);
            if ((st.flags[i] & (BlockState::F_SIG | BlockState::F_VIS))
                || st.has_sig_nbr(x, y)) {
              agg = false;
              break;
            }
          }
          if (agg) {
            if (mqd->decode(CTX_RL) == 0) continue;
            int r = (mqd->decode(CTX_UNI) << 1) | mqd->decode(CTX_UNI);
            int y = k + r;
            int s = decode_sign(x, y, false);
            int i = st.idx(x, y);
            st.set_sig(x, y);
            st.neg[i] = (uint8_t)s;
            neg[i] = (uint8_t)s;
            mag[i] |= (1u << plane);
            start = r + 1;
          }
        }
        for (int y = k + start; y < k + sh; y++) {
          int i = st.idx(x, y);
          if (st.flags[i] & (BlockState::F_SIG | BlockState::F_VIS))
            continue;
          int bit = mqd->decode(st.zc_ctx(x, y));
          if (bit) {
            int s = decode_sign(x, y, false);
            st.set_sig(x, y);
            st.neg[i] = (uint8_t)s;
            neg[i] = (uint8_t)s;
            mag[i] |= (1u << plane);
          }
        }
      }
    }
    if (segsym) {
      for (int j = 0; j < 4; j++) mqd->decode(CTX_UNI);
    }
  };

  int num_passes_total = 3 * numbps - 2;
  int passno = 0;
  for (int plane = numbps - 1; plane >= 0; plane--) {
    int first = (plane == numbps - 1) ? PASS_CLN : PASS_SIG;
    for (int ptype = first; ptype <= PASS_CLN; ptype++) {
      if (passno >= numpasses) return;
      bool raw = lazy && ptype != PASS_CLN && passno >= 10;
      if (raw) get_raw(); else get_mq();
      if (ptype == PASS_SIG) spp(plane, raw);
      else if (ptype == PASS_REF) mrp(plane, raw);
      else cp(plane);
      bool is_last = passno == num_passes_total - 1;
      if (termall || is_last || (lazy && lazy_boundary(passno, ptype))) {
        end_coder();
      } else if (reset && mqd) {
        init_states(ctx);
      }
      passno++;
    }
  }
}

}  // namespace

namespace {

// Run body(i) for i in [0, n) on min(nthreads, n) workers (the calling
// thread is one of them), each taking the next index from one counter.
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
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Single-block encode. Returns encoded length (>= 0) or -1 if out_cap too
// small. pass arrays must have room for 3*32-2 = 94 entries.
int grok_t1_encode(const uint32_t* mag, const uint8_t* neg, int w, int h,
                   int orient, int style, uint8_t* out_buf, int out_cap,
                   int32_t* meta /* [numbps, numpasses] */,
                   int32_t* pass_rates, double* pass_dist,
                   uint8_t* pass_term) {
  std::vector<uint8_t> out;
  std::vector<PassRec> passes;
  int numbps = 0, numpasses = 0;
  int n = encode_cblk(mag, neg, w, h, orient, style, out, &numbps,
                      &numpasses, passes);
  if (n > out_cap) return -1;
  std::memcpy(out_buf, out.data(), n);
  meta[0] = numbps;
  meta[1] = numpasses;
  for (size_t i = 0; i < passes.size(); i++) {
    pass_rates[i] = passes[i].rate;
    pass_dist[i] = passes[i].dist;
    pass_term[i] = passes[i].terminated;
  }
  return n;
}

int grok_t1_decode(const uint8_t* data, int len, const int32_t* seg_lens,
                   int nsegs, int w, int h, int orient, int numbps,
                   int numpasses, int style, uint32_t* mag, uint8_t* neg) {
  decode_cblk(data, len, seg_lens, nsegs, w, h, orient, numbps, numpasses,
              style, mag, neg);
  return 0;
}

// Batch encode over nthreads workers. Blocks are packed contiguously:
//   desc[i*4 + 0] = offset into mag_flat/neg_flat
//   desc[i*4 + 1] = w, desc[i*4+2] = h, desc[i*4+3] = orient
// Outputs: out_flat with per-block capacity out_stride;
//   out_meta[i*3] = length, [i*3+1] = numbps, [i*3+2] = numpasses;
//   pass arrays with stride pass_stride per block.
// Returns -1 when a block's output exceeds out_stride.
int grok_t1_encode_batch(int nblocks, const uint32_t* mag_flat,
                         const uint8_t* neg_flat, const int64_t* desc,
                         int style, uint8_t* out_flat, int out_stride,
                         int32_t* out_meta, int32_t* pass_rates,
                         double* pass_dist, uint8_t* pass_term,
                         int pass_stride, int nthreads) {
  std::atomic<int> err(0);
  parallel_for(nblocks, nthreads, [&](int i) {
    const int64_t* d = desc + (size_t)i * 4;
    std::vector<uint8_t> out;
    std::vector<PassRec> passes;
    int numbps = 0, numpasses = 0;
    int n = encode_cblk(mag_flat + d[0], neg_flat + d[0], (int)d[1],
                        (int)d[2], (int)d[3], style, out, &numbps,
                        &numpasses, passes);
    if (n > out_stride) {
      err.store(1);
      return;
    }
    std::memcpy(out_flat + (size_t)i * out_stride, out.data(), n);
    out_meta[i * 3] = n;
    out_meta[i * 3 + 1] = numbps;
    out_meta[i * 3 + 2] = numpasses;
    for (size_t j = 0; j < passes.size() && (int)j < pass_stride; j++) {
      pass_rates[(size_t)i * pass_stride + j] = passes[j].rate;
      pass_dist[(size_t)i * pass_stride + j] = passes[j].dist;
      pass_term[(size_t)i * pass_stride + j] = passes[j].terminated;
    }
  });
  return err.load() ? -1 : 0;
}

// Batch decode. desc per block (int64):
//   [0]=data offset, [1]=data len, [2]=seg offset, [3]=nsegs,
//   [4]=w, [5]=h, [6]=orient, [7]=numbps, [8]=numpasses, [9]=style,
//   [10]=output offset into mag/neg flats
int grok_t1_decode_batch(int nblocks, const uint8_t* data_flat,
                         const int32_t* seg_lens_flat, const int64_t* desc,
                         uint32_t* mag_flat, uint8_t* neg_flat,
                         int nthreads, int signed_out) {
  parallel_for(nblocks, nthreads, [&](int i) {
    const int64_t* d = desc + (size_t)i * 11;
    decode_cblk(data_flat + d[0], (int)d[1],
                seg_lens_flat + d[2], (int)d[3], (int)d[4], (int)d[5],
                (int)d[6], (int)d[7], (int)d[8], (int)d[9],
                mag_flat + d[10], neg_flat + d[10]);
    if (signed_out) {
      int n = (int)(d[4] * d[5]);
      int32_t* out = (int32_t*)(mag_flat + d[10]);
      const uint8_t* neg = neg_flat + d[10];
      for (int j = 0; j < n; j++) {
        int32_t v = (int32_t)out[j];
        out[j] = neg[j] ? -v : v;
      }
    }
  });
  return 0;
}

// Decode into band planes: each block decoded into scratch, then
// scattered into its band plane with its sign (and the mid-point
// dequantization of float bands). desc per block (int64 x 14):
//   [0]=data offset, [1]=data len, [2]=seg offset, [3]=nsegs, [4]=w,
//   [5]=h, [6]=orient, [7]=numbps, [8]=numpasses, [9]=style,
//   [10]=band index, [11]=x0, [12]=y0 (within band),
//   [13]=1 to reconstruct at plane 0 rather than at the lowest decoded
//   plane (an ROI component of a tile with COC overrides, as the host
//   decoder's per-block route reconstructs it), else 0
int grok_t1_decode_bands(int nblocks, const uint8_t* data_flat,
                         const int32_t* seg_lens_flat, const int64_t* desc,
                         const int64_t* band_ptrs,
                         const int64_t* band_strides, const double* steps,
                         int is_float, int nthreads) {
  parallel_for(nblocks, nthreads, [&](int i) {
    const int64_t* d = desc + (size_t)i * 14;
    int w = (int)d[4], h = (int)d[5];
    size_t wh = (size_t)w * h;
    std::vector<uint32_t> mag(wh);
    std::vector<uint8_t> neg(wh);
    decode_cblk(data_flat + d[0], (int)d[1],
                seg_lens_flat + d[2], (int)d[3], w, h,
                (int)d[6], (int)d[7], (int)d[8], (int)d[9],
                mag.data(), neg.data());
    int64_t stride = band_strides[d[10]];
    // Truncated-block reconstruction: the mid-point offset belongs at
    // the block's lowest DECODED plane, not plane 0 (reference embeds
    // the half at decode time: t1.cpp oneplushalf, scaled out in
    // T1Part1.cpp post_decode). p_min = 0 for fully decoded blocks.
    int numbps_i = (int)d[7], numpasses_i = (int)d[8];
    int pmin = 0;
    if (numbps_i > 0 && numpasses_i > 0 && !d[13]) {
      pmin = numbps_i - 1 - ((numpasses_i + 1) / 3);
      if (pmin < 0) pmin = 0;
    }
    if (is_float) {
      float* band = (float*)(uintptr_t)band_ptrs[d[10]];
      float step = (float)steps[d[10]];
      float halff = 0.5f * (float)(1u << pmin);
      for (int y = 0; y < h; y++) {
        float* dst = band + (size_t)(d[12] + y) * stride + d[11];
        const uint32_t* ms = mag.data() + (size_t)y * w;
        const uint8_t* ns = neg.data() + (size_t)y * w;
        for (int x = 0; x < w; x++) {
          float m = (float)ms[x];
          if (ms[x]) m += halff;
          float v = m * step;
          dst[x] = ns[x] ? -v : v;
        }
      }
    } else {
      int32_t* band = (int32_t*)(uintptr_t)band_ptrs[d[10]];
      int32_t halfi = pmin > 0 ? (int32_t)(1 << (pmin - 1)) : 0;
      for (int y = 0; y < h; y++) {
        int32_t* dst = band + (size_t)(d[12] + y) * stride + d[11];
        const uint32_t* ms = mag.data() + (size_t)y * w;
        const uint8_t* ns = neg.data() + (size_t)y * w;
        for (int x = 0; x < w; x++) {
          int32_t v = (int32_t)ms[x];
          if (v) v += halfi;
          dst[x] = ns[x] ? -v : v;
        }
      }
    }
  });
  return 0;
}

// Gather code-blocks out of per-band signed-int32 coefficient planes into
// the (mag, neg) flats the batch coders consume (abs/sign split and the
// strided block copy). desc per block (int64 x 6):
//   [0]=band index, [1]=x0, [2]=y0 (within band), [3]=w, [4]=h,
//   [5]=output offset into mag/neg flats
int grok_extract_blocks(int nblocks, const int64_t* band_ptrs,
                        const int64_t* band_strides, const int64_t* desc,
                        uint32_t* mag_flat, uint8_t* neg_flat,
                        int nthreads) {
  parallel_for(nblocks, nblocks >= 32 ? nthreads : 1, [&](int i) {
    const int64_t* d = desc + (size_t)i * 6;
    const int32_t* band = (const int32_t*)(uintptr_t)band_ptrs[d[0]];
    int64_t stride = band_strides[d[0]];
    int w = (int)d[3], h = (int)d[4];
    uint32_t* mo = mag_flat + d[5];
    uint8_t* no = neg_flat + d[5];
    for (int y = 0; y < h; y++) {
      const int32_t* src = band + (size_t)(d[2] + y) * stride + d[1];
      for (int x = 0; x < w; x++) {
        int32_t v = src[x];
        mo[x] = (uint32_t)(v < 0 ? -v : v);
        no[x] = v < 0;
      }
      mo += w;
      no += w;
    }
  });
  return 0;
}

// Float-band variant for the irreversible path: deadzone quantization
// (mag = floor(|v| / step), matching numpy float64 floor-division) fused
// into the block gather. desc layout as grok_extract_blocks; steps holds
// one double stepsize per band.
int grok_extract_blocks_f32(int nblocks, const int64_t* band_ptrs,
                            const int64_t* band_strides,
                            const double* steps, const int64_t* desc,
                            uint32_t* mag_flat, uint8_t* neg_flat,
                            int nthreads) {
  parallel_for(nblocks, nblocks >= 32 ? nthreads : 1, [&](int i) {
    const int64_t* d = desc + (size_t)i * 6;
    const float* band = (const float*)(uintptr_t)band_ptrs[d[0]];
    int64_t stride = band_strides[d[0]];
    double step = steps[d[0]];
    int w = (int)d[3], h = (int)d[4];
    uint32_t* mo = mag_flat + d[5];
    uint8_t* no = neg_flat + d[5];
    for (int y = 0; y < h; y++) {
      const float* src = band + (size_t)(d[2] + y) * stride + d[1];
      for (int x = 0; x < w; x++) {
        float v = src[x];
        double m = (double)(v < 0 ? -v : v) / step;
        mo[x] = (uint32_t)m;  // m >= 0: cast == floor
        no[x] = v < 0;
      }
      mo += w;
      no += w;
    }
  });
  return 0;
}

}  // extern "C"
