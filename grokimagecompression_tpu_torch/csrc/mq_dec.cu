// EBCOT Part-1 MQ block decoder (default code-block style), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of
// grokimagecompression_tpu/ops/mq_dec_pallas.py (pallas_call at :538,
// entry decode_core_pallas at :594). It computes what
// ops/mq_dec_jax.decode_core computes, bit for bit: per lane one
// code-block's codeword segment in, its samples out as
// sign << 31 | magnitude.
//
// Input: the lanes' raw segments concatenated (`data`), lane b's at
// data[off[b] .. off[b + 1]), its magnitude bit-planes `nbps`, coding
// passes `npas` and band orientation `ori`, and an order of the lanes
// (`order`: thread k of the grid decodes lane order[k]). Output: (h*w, B)
// int32 samples, row-major, lanes last (lane order), zeroed by the
// caller; (2, B) int32 statistics: the decisions decoded and the BYTEINs
// run per lane.
//
// What bounds it: a lane's decisions depend one on the next (each context
// state, each interval), so one code-block is one thread walking a
// dependent chain, and the kernel is bound by that chain's latency, not by
// the bytes (a config-1 chunk's 64x64 group reads ~6 MB of segments and
// writes 33 MB of samples, ~12 us of HBM time). The chain's links are the
// decisions and the visits of the stripe columns in every pass, each a
// run of dependent instructions of a single thread; the deepest lane's
// chain alone sets the kernel's time from below (PERF.md measures it
// alone). The design keeps each link to few instructions and at most two
// shared-memory loads (a context's LUT entry, then its word), and takes
// every global access off the chain:
//   - per lane one 32-bit state word per stripe column (4 rows x 1
//     column) over a bordered (h/4 + 2) x (w + 2) grid (the layout of
//     OpenJPEG's and Grok's t1 flags): the significance of the 6 x 3
//     neighbourhood of its 4 samples (bits 0-17, bit 3 (r + 1) + dx + 1
//     for row r in -1 .. 4 and dx in -1 .. 1), the signs of rows -1 .. 4
//     (bits 18-23), visited in this plane (24-27) and refined (28-31). A
//     sample that becomes significant sets its bits in its own word and
//     its left and right neighbours', and for rows 0 and 3 in the three
//     words of the stripe above or below. The zero-coding context is one
//     table lookup on 9 bits of the word, the sign context one lookup on
//     8 bits of the word and its left and right neighbours, the
//     refinement context one bit test; the border words stay outside the
//     block and count as insignificant. At 64x64: 18 x 66 x 4 B = 4.6 KB
//     a lane in shared memory;
//   - a pass walks a stripe with the words of the column and its two
//     neighbours in registers and the next word loaded a column ahead, so
//     a column's visit waits on no load. A few bit operations on the word
//     give the column's candidate rows at once, and a column without one
//     costs a test: significance propagation takes the insignificant rows
//     with a significant neighbour, refinement the significant rows not
//     visited, the cleanup the rows neither significant nor visited, after
//     testing the run-length condition (a full stripe, nothing significant
//     in the 6 x 3 box, nothing visited) with one compare;
//   - the context word of mq_tables.cuh: a decision reads one shared word
//     (Qe, NMPS, NLPS, SWITCH and the MPS); Table C.2 is read only on a
//     transition. RENORMD shifts by the count of leading zeros of A;
//   - BYTEIN reads from an 8-byte window of the segment in registers; the
//     next aligned 4-byte word is loaded as soon as the window moves, a
//     word ahead of need, so its latency hides behind the decisions;
//   - magnitudes go to the output with atomicOr (a reduction whose result
//     is unused: RED), never read back; the output starts at 0, so the
//     order of a sample's ORs does not matter;
//   - kLanes lanes a block of one warp. Lanes that share a warp diverge
//     over different code-blocks and take turns, so the fewer the faster:
//     chip_smoke.py builds 16, 8, 4, 2 and 1 and times them in turns, and
//     one lane a block, a warp of its own, is the fastest (PERF.md); the
//     2016 lanes of a config-1 chunk's 64x64 group make 2016 blocks of
//     ~8 KB of shared memory, ~15 an SM, all resident at once. The blocks
//     take the lanes in the wrapper's order (by passes, then segment
//     bytes, descending), so that the deepest start first (and, with more
//     lanes a block, the lanes of a warp end together). A block of a very
//     wide geometry takes fewer lanes to fit in shared memory;
//   - each lane walks its own passes from its first cleanup: passes line
//     up by type across the lanes of a warp whatever their bit-plane
//     counts.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream and returns the first CUDA error.

#include <cstdint>
#include <cuda_runtime.h>

#include "mq_tables.cuh"

namespace {

constexpr int kLanes = 1;
constexpr int kCtxSc = 9, kCtxMag = 14, kCtxRl = 17, kCtxUni = 18;
constexpr int kMaxShared = 227 * 1024;

// state word bits
constexpr uint32_t kNbrs = 0x1EFu;          // a row's 3 x 3, centre out
constexpr uint32_t kRunFree = 0x0FFFFFFFu;  // significance, signs, visited
constexpr int kChi = 19;                    // sign of row r at kChi + r
constexpr int kVis = 24, kRef = 28;
constexpr uint32_t kRows = 0x249u;          // one bit a row: row k at 3 k

// Rows of a word, one bit a row at 3 k: significant; visited; with
// anything significant in the row's 3 x 3 (its own sample included).
__device__ __forceinline__ uint32_t sig_rows(uint32_t own) {
  return (own >> 4) & kRows;
}
__device__ __forceinline__ uint32_t vis_rows(uint32_t own) {
  const uint32_t v = own >> kVis;
  return (v & 1) | ((v & 2) << 2) | ((v & 4) << 4) | ((v & 8) << 6);
}
__device__ __forceinline__ uint32_t box_rows(uint32_t own) {
  const uint32_t t = own | (own >> 1) | (own >> 2);   // each row's 3 bits
  return (t | (t >> 3) | (t >> 6)) & kRows;
}
// the row of the lowest set bit of a row mask (bit 3 k -> k)
__device__ __forceinline__ int first_row(uint32_t rows) {
  return ((__ffs(rows) - 1) * 43) >> 7;
}

// Table D.1: zero-coding context from the significant horizontal,
// vertical and diagonal neighbour counts (HL swaps h and v; HH is
// diagonal-major).
__host__ __device__ constexpr int zc_rule(int orient, int h, int v, int d) {
  if (orient == 1) {
    const int t = h;
    h = v;
    v = t;
  }
  if (orient == 3) {
    const int hv = h + v;
    if (d >= 3) return 8;
    if (d == 2) return hv >= 1 ? 7 : 6;
    if (d == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
    return hv >= 2 ? 2 : hv;
  }
  if (h == 2) return 8;
  if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
  if (v) return 2 + v;
  return d >= 2 ? 2 : d;
}

// Table D.3 on the sign LUT's index (bit 0 the left neighbour's sign,
// 1 its significance, 2 / 3 the right's, 4 / 5 the upper's, 6 / 7 the
// lower's): the sign context's offset from kCtxSc | prediction bit << 3.
__host__ __device__ constexpr int sc_rule(int i) {
  int c[4] = {0, 0, 0, 0};
  for (int n = 0; n < 4; ++n)
    c[n] = (i >> (2 * n + 1)) & 1 ? 1 - 2 * ((i >> (2 * n)) & 1) : 0;
  int hc = c[0] + c[1], vc = c[2] + c[3];
  hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
  vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
  const int spb = hc < 0 || (hc == 0 && vc < 0);
  if (spb) {
    hc = -hc;
    vc = -vc;
  }
  const int off = hc == 1 ? (vc == 1 ? 4 : vc == 0 ? 3 : 2)
                          : (vc == 1 ? 1 : 0);
  return off | (spb << 3);
}

// zc[orient * 512 + the 9 bits of a row's 3 x 3 neighbourhood], then
// sc[the 8-bit sign index]
struct alignas(16) Luts {
  uint8_t v[4 * 512 + 256];
};

__host__ __device__ constexpr Luts make_luts() {
  Luts t{};
  for (int i = 0; i < 4 * 512; ++i) {
    const int n = i & 511;
    const int h = ((n >> 3) & 1) + ((n >> 5) & 1);
    const int v = ((n >> 1) & 1) + ((n >> 7) & 1);
    const int d = (n & 1) + ((n >> 2) & 1) + ((n >> 6) & 1) + ((n >> 8) & 1);
    t.v[i] = static_cast<uint8_t>(zc_rule(i >> 9, h, v, d));
  }
  for (int i = 0; i < 256; ++i)
    t.v[4 * 512 + i] = static_cast<uint8_t>(sc_rule(i));
  return t;
}

__device__ const Luts kLuts = make_luts();

struct Decoder {
  uint32_t a, c;
  int ct, pos, end;        // byte position and length of the segment
  const uint32_t* wp;      // aligned words, wp[0] holding the first byte
  int d0, wi;              // first byte's offset in wp[0]; window's word
  uint64_t cur;            // window: words wi and wi + 1
  uint32_t nxt;            // word wi + 2, loaded ahead
  int ndec, nbytein;

  // word k of the segment's aligned words, if it holds a segment byte
  __device__ __forceinline__ uint32_t load(int k) const {
    return 4 * k < d0 + end ? __ldg(wp + k) : 0xFFFFFFFFu;
  }
  __device__ __forceinline__ void step() {
    ++pos;
    if (pos + d0 - 4 * wi >= 4) {
      cur = (cur >> 32) | (static_cast<uint64_t>(nxt) << 32);
      ++wi;
      nxt = load(wi + 2);
    }
  }

  // BYTEIN (C.3.4). Past the segment's end, and at a 0xFF followed by a
  // byte above 0x8F (a marker), C takes 0xFF00 and the position stays.
  __device__ __forceinline__ void bytein() {
    ++nbytein;
    if (pos < end) {
      const int q = 8 * (pos + d0 - 4 * wi);
      const uint32_t byte = static_cast<uint32_t>(cur >> q) & 0xFFu;
      const uint32_t nb =
          pos + 1 < end ? static_cast<uint32_t>(cur >> (q + 8)) & 0xFFu
                        : 0xFFu;
      if (byte == 0xFF) {
        if (nb > 0x8F) {
          c += 0xFF00u;
          ct = 8;
        } else {
          step();
          c += nb << 9;
          ct = 7;
        }
      } else {
        step();
        c += nb << 8;
        ct = 8;
      }
    } else {
      c += 0xFF00u;
      ct = 8;
    }
  }

  // INITDEC (C.3.5) of the segment at `seg`, `len` bytes
  __device__ __forceinline__ void init(const uint8_t* seg, int len) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(seg);
    wp = reinterpret_cast<const uint32_t*>(p & ~uintptr_t{3});
    d0 = static_cast<int>(p & 3);
    end = len;
    pos = 0;
    wi = 0;
    cur = load(0) | (static_cast<uint64_t>(load(1)) << 32);
    nxt = load(2);
    ndec = 0;
    nbytein = 0;
    c = (len > 0 ? static_cast<uint32_t>(cur >> (8 * d0)) & 0xFFu : 0xFFu)
        << 16;
    ct = 0;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000u;
  }

  // DECODE (C.3.2) with RENORMD (C.3.3) in the context word at `cp`
  __device__ __forceinline__ int decode(uint32_t* cp, const uint32_t* rows) {
    ++ndec;
    const uint32_t cw = *cp;
    const uint32_t qe = cw >> 16;
    const int mps = cw & 1;
    int lps;
    a -= qe;
    if ((c >> 16) < qe) {   // LPS sub-interval, conditional exchange
      lps = a >= qe;
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000u) return mps;   // MPS without renormalisation
      lps = a < qe;
    }
    *cp = ctx_next(cw, lps, rows);
    int n = __clz(a) - 16;   // A is in [1, 0x7FFF]
    a <<= n;
    while (n > 0) {
      if (ct == 0) bytein();
      const int s = n < ct ? n : ct;
      c <<= s;
      ct -= s;
      n -= s;
    }
    return mps ^ lps;
  }
};

struct Lane {
  Decoder s;
  uint32_t* f;            // the lane's state words, f[i]
  uint32_t* ctx;          // ctx[cx * kLanes]: the lane's context words
  const uint32_t* rows;   // Table C.2 as context words
  const uint8_t* zc;      // zero-coding LUT of the lane's orientation
  const uint8_t* sc;      // sign LUT
  uint32_t* out;          // out[i * B]: the lane's samples
  int B, w, W;            // W = w + 2 words a grid row

  __device__ __forceinline__ int dec(int cx) {
    return s.decode(ctx + cx * kLanes, rows);
  }

  // Sign decoding (Table D.3) of row k of the column at word i (sample
  // (y, x)), which becomes significant in `bit`'s plane. `own`, `l` and
  // `r` are the words of the column and its left and right neighbours,
  // held in registers; the words of the stripes above and below learn of
  // it in shared memory.
  __device__ __forceinline__ void sign(int i, int k, uint32_t& l,
                                       uint32_t& own, uint32_t& r, int y,
                                       int x, uint32_t bit) {
    const int t = 3 * k;
    const int idx = ((l >> (kChi + k)) & 1) | ((own >> (t + 2)) & 2) |
                    (((r >> (kChi + k)) & 1) << 2) |
                    (((own >> (t + 5)) & 1) << 3) |
                    (((own >> (kChi - 1 + k)) & 1) << 4) |
                    (((own >> (t + 1)) & 1) << 5) |
                    (((own >> (kChi + 1 + k)) & 1) << 6) |
                    (((own >> (t + 7)) & 1) << 7);
    const int e = sc[idx];
    const uint32_t neg = dec(kCtxSc + (e & 7)) ^ (e >> 3);
    own |= (1u << (t + 4)) | (neg << (kChi + k));
    l |= 1u << (t + 5);
    r |= 1u << (t + 3);
    if (k == 0) {
      uint32_t* u = f + i - W;
      u[-1] |= 1u << 17;
      u[0] |= (1u << 16) | (neg << (kChi + 4));
      u[1] |= 1u << 15;
    } else if (k == 3) {
      uint32_t* d = f + i + W;
      d[-1] |= 1u << 2;
      d[0] |= 2u | (neg << (kChi - 1));
      d[1] |= 1u;
    }
    atomicOr(out + static_cast<size_t>(y * w + x) * B, bit | (neg << 31));
  }

  // significance propagation over one stripe column: the insignificant
  // samples with a significant neighbour, in row order; a row that becomes
  // significant can make the next one a candidate
  __device__ __forceinline__ void spp(int i, int y0, int x, uint32_t rows,
                                      uint32_t bit, uint32_t& l,
                                      uint32_t& own, uint32_t& r) {
    uint32_t cand = box_rows(own) & ~sig_rows(own) & rows;
    while (cand) {
      const int k = first_row(cand);
      const uint32_t later = rows & ~((2u << (3 * k)) - 1);
      const int d = dec(zc[(own >> (3 * k)) & 0x1FFu]);
      own |= 1u << (kVis + k);
      if (d) {
        sign(i, k, l, own, r, y0 + k, x, bit);
        cand = box_rows(own) & ~sig_rows(own) & later;
      } else {
        cand &= later;
      }
    }
  }

  // magnitude refinement over one stripe column: the significant samples
  // not visited in this plane
  __device__ __forceinline__ void mrp(int i, int y0, int x, uint32_t rows,
                                      uint32_t bit, uint32_t&, uint32_t& own,
                                      uint32_t&) {
    uint32_t cand = sig_rows(own) & ~vis_rows(own) & rows;
    while (cand) {
      const int k = first_row(cand);
      cand &= cand - 1;
      const int cx = (own >> (kRef + k)) & 1
                         ? kCtxMag + 2
                         : kCtxMag + ((own >> (3 * k)) & kNbrs ? 1 : 0);
      if (dec(cx))
        atomicOr(out + static_cast<size_t>((y0 + k) * w + x) * B, bit);
      own |= 1u << (kRef + k);
    }
  }

  // cleanup over one stripe column, with run-length aggregation on full
  // stripes whose 6 x 3 box holds nothing significant and whose column
  // holds nothing visited; it ends the plane, so it clears "visited"
  __device__ __forceinline__ void cln(int i, int y0, int x, uint32_t rows,
                                      uint32_t bit, uint32_t& l,
                                      uint32_t& own, uint32_t& r) {
    if (rows == kRows && !(own & kRunFree)) {
      if (!dec(kCtxRl)) return;   // the column stays insignificant
      int rr = dec(kCtxUni) << 1;
      rr |= dec(kCtxUni);
      // the run-interrupt sample: significant, no zero-coding decision
      sign(i, rr, l, own, r, y0 + rr, x, bit);
      rows &= ~((2u << (3 * rr)) - 1);
    }
    // the samples neither significant nor visited, in row order
    uint32_t cand = ~(sig_rows(own) | vis_rows(own)) & rows;
    while (cand) {
      const int k = first_row(cand);
      cand &= cand - 1;
      if (dec(zc[(own >> (3 * k)) & 0x1FFu]))
        sign(i, k, l, own, r, y0 + k, x, bit);
    }
    own &= ~(0xFu << kVis);
  }

  // One pass over the stripe whose first column's word is at i0, left to
  // right. The words of the column and of its two neighbours ride in
  // registers and the word after them is loaded a column ahead, so a
  // column's visit waits on no load; a word goes back to shared memory
  // where it changed.
  template <int kType>
  __device__ __forceinline__ void stripe(int i0, int y0, int sh,
                                         uint32_t bit) {
    const uint32_t rows = kRows >> (3 * (4 - sh));   // the stripe's rows
    uint32_t l = f[i0 - 1], own = f[i0], r = f[i0 + 1];
    uint32_t l_mem = l, own_mem = own, r_mem = r;
    for (int x = 0; x < w; ++x) {
      const int i = i0 + x;
      // the word after the right neighbour: this column changes it only
      // through a stripe above or below, which never holds it (W >= 4),
      // or for w = 1, where it is never used
      const uint32_t ahead = f[i + 2];
      if (kType == 0)
        spp(i, y0, x, rows, bit, l, own, r);
      else if (kType == 1)
        mrp(i, y0, x, rows, bit, l, own, r);
      else
        cln(i, y0, x, rows, bit, l, own, r);
      if (l != l_mem) f[i - 1] = l;
      if (own != own_mem) f[i] = own;
      l = own;
      l_mem = own;
      own = r;
      own_mem = r_mem;
      r = ahead;
      r_mem = ahead;
    }
  }
};

__global__ void __launch_bounds__(kLanes)
mq_dec_kernel(const uint8_t* __restrict__ data,
              const int64_t* __restrict__ off,
              const int32_t* __restrict__ nbps,
              const int32_t* __restrict__ npas,
              const int32_t* __restrict__ ori,
              const int32_t* __restrict__ order, int B, int w, int h,
              int stride, uint32_t* __restrict__ out,
              int32_t* __restrict__ stats) {
  extern __shared__ uint32_t words[];   // [lanes][stride]
  __shared__ uint32_t rows[kStates];
  __shared__ uint32_t ctx[kCtxUni + 1][kLanes];
  __shared__ __align__(16) Luts luts;
  const int tid = threadIdx.x;
  const int nl = blockDim.x;
  for (int i = tid; i < kStates; i += nl) rows[i] = ctx_row(i);
  {
    const uint4* src = reinterpret_cast<const uint4*>(&kLuts);
    uint4* dst = reinterpret_cast<uint4*>(&luts);
    for (int i = tid; i < static_cast<int>(sizeof(Luts) / 16); i += nl)
      dst[i] = src[i];
  }
  for (int i = 0; i < kNumCtxs; ++i) ctx[i][tid] = ctx_init(i);
  const int S = (h + 3) / 4, W = w + 2;
  uint32_t* f = words + static_cast<size_t>(tid) * stride;
  for (int i = 0; i < (S + 2) * W; ++i) f[i] = 0u;
  __syncthreads();
  const int k0 = blockIdx.x * nl + tid;
  if (k0 >= B) return;
  const int b = order[k0];

  Lane L;
  L.f = f;
  L.ctx = &ctx[0][tid];
  L.rows = rows;
  L.zc = luts.v + 512 * ori[b];
  L.sc = luts.v + 4 * 512;
  L.out = out + b;
  L.B = B;
  L.w = w;
  L.W = W;
  L.s.init(data + off[b], static_cast<int>(off[b + 1] - off[b]));

  // the lane's passes: the cleanup of plane nb - 1, then (SPP, MRP, CLN)
  // per plane below it, down to plane 0 at most
  const int nb = nbps[b];
  const int np = nb > 0 ? min(npas[b], 3 * nb - 2) : 0;
  for (int p = 0; p < np; ++p) {
    const int type = (p + 2) % 3;   // 0 SPP, 1 MRP, 2 CLN
    const uint32_t bit = 1u << (nb - 1 - (p + 2) / 3);
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int sh = min(4, h - y0);
      const int i0 = (y0 / 4 + 1) * W + 1;
      if (type == 0)
        L.stripe<0>(i0, y0, sh, bit);
      else if (type == 1)
        L.stripe<1>(i0, y0, sh, bit);
      else
        L.stripe<2>(i0, y0, sh, bit);
    }
  }
  stats[b] = L.s.ndec;
  stats[B + b] = L.s.nbytein;
}

}  // namespace

extern "C" {

// data: (N,) uint8; off: (B + 1,) int64; nbps, npas, ori: (B,) int32;
// order: (B,) int32, a permutation of the lanes; out: (h*w, B) int32,
// zeroed; stats: (2, B) int32.
int mq_dec_group(const void* data, const void* off, const void* nbps,
                 const void* npas, const void* ori, const void* order, int B,
                 int w, int h, void* out, void* stats, void* stream) {
  // an odd stride spreads the lanes' words over the banks
  const int stride = (((h + 3) / 4 + 2) * (w + 2)) | 1;
  const int fixed = static_cast<int>(sizeof(uint32_t) *
                                         (kStates + (kCtxUni + 1) * kLanes) +
                                     sizeof(Luts));
  int nl = kLanes;
  while (nl > 1 && nl * stride * 4 + fixed > kMaxShared) nl /= 2;
  const int shmem = nl * stride * 4;
  cudaError_t e = cudaFuncSetAttribute(
      mq_dec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mq_dec_kernel<<<(B + nl - 1) / nl, nl, shmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(off),
      static_cast<const int32_t*>(nbps), static_cast<const int32_t*>(npas),
      static_cast<const int32_t*>(ori), static_cast<const int32_t*>(order),
      B, w, h, stride, static_cast<uint32_t*>(out),
      static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
