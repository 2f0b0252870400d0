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
// passes `npas` and band orientation `ori`. Output: (h*w, B) int32
// samples, row-major, lanes last, zeroed by the caller; (2, B) int32
// statistics: the decisions decoded and the BYTEINs run per lane.
//
// What bounds it: a lane's decisions depend one on the next (each
// context state, each interval), so one code-block is one thread walking
// a dependent chain, and the kernel is bound by that latency, not by the
// bytes (a config-1 chunk's 64x64 group reads ~6 MB of segments and
// writes 33 MB of samples, ~12 us of HBM time). The design:
//   - one thread per lane, 16 lanes a block (so that the 2016 lanes of a
//     config-1 chunk spread over 126 blocks, one or two per SM, and a
//     warp's lanes diverge over 16 code-blocks, not 32);
//   - A, C, CT and the byte position in registers; the 19 context states
//     and Table C.2 in shared memory;
//   - BYTEIN on the raw bytes with indexed loads, where the TPU kernel
//     unstuffed every segment on the host into field words and refilled a
//     window by one-hot selects;
//   - per lane four flag bit-planes in shared memory over the padded
//     (h + 2) x (w + 2) grid, whose border stays 0 (neighbours outside
//     the block count as insignificant): significant, negative, visited
//     in this plane, refined. At 64x64 that is 2.2 KB a lane. The
//     words are interleaved across the block's lanes, so a warp reading
//     one word index hits 16 banks. "Refined" (the sample had an MRP
//     pass before) replaces the reference's mag >> (plane + 2) != 0;
//   - magnitudes accumulated in place in the output, lanes last, so a
//     warp's stores to one sample coalesce;
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

constexpr int kLanes = 16;
constexpr int kSig = 0, kNeg = 1, kVis = 2, kRef = 3, kPlanes = 4;
constexpr int kCtxSc = 9, kCtxMag = 14, kCtxRl = 17, kCtxUni = 18;

// Table D.1: zero-coding context from the significant horizontal,
// vertical and diagonal neighbour counts (HL swaps h and v; HH is
// diagonal-major).
__device__ int zc_rule(int orient, int h, int v, int d) {
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

struct Decoder {
  uint32_t a, c;
  int ct, pos, end;
  const uint8_t* seg;
  int ndec, nbytein;
};

// BYTEIN (C.3.4). Past the segment's end, and at a 0xFF followed by a
// byte above 0x8F (a marker), C takes 0xFF00 and the position stays.
__device__ __forceinline__ void bytein(Decoder& s) {
  ++s.nbytein;
  if (s.pos < s.end) {
    const uint32_t nxt = s.pos + 1 < s.end ? s.seg[s.pos + 1] : 0xFFu;
    if (s.seg[s.pos] == 0xFF) {
      if (nxt > 0x8F) {
        s.c += 0xFF00u;
        s.ct = 8;
      } else {
        ++s.pos;
        s.c += nxt << 9;
        s.ct = 7;
      }
    } else {
      ++s.pos;
      s.c += nxt << 8;
      s.ct = 8;
    }
  } else {
    s.c += 0xFF00u;
    s.ct = 8;
  }
}

// DECODE (C.3.2) with RENORMD (C.3.3); `cp` is the lane's context state
// (index << 1 | mps).
__device__ __forceinline__ int decode(Decoder& s, uint8_t* cp,
                                      const uint32_t* tbl) {
  ++s.ndec;
  const int p = *cp;
  const int mps = p & 1;
  const uint32_t row = tbl[p >> 1];
  const uint32_t qe = row >> 13;
  const uint8_t to_mps = static_cast<uint8_t>((((row >> 7) & 63) << 1) | mps);
  const uint8_t to_lps =
      static_cast<uint8_t>((((row >> 1) & 63) << 1) | (mps ^ (row & 1)));
  int d;
  s.a -= qe;
  if ((s.c >> 16) < qe) {   // LPS sub-interval, conditional exchange
    if (s.a < qe) {
      d = mps;
      *cp = to_mps;
    } else {
      d = 1 - mps;
      *cp = to_lps;
    }
    s.a = qe;
  } else {
    s.c -= qe << 16;
    if (s.a & 0x8000u) return mps;   // MPS without renormalisation
    if (s.a < qe) {
      d = 1 - mps;
      *cp = to_lps;
    } else {
      d = mps;
      *cp = to_mps;
    }
  }
  do {
    if (s.ct == 0) bytein(s);
    s.a <<= 1;
    s.c <<= 1;
    --s.ct;
  } while (!(s.a & 0x8000u));
  return d;
}

// One lane's flag bit-planes in shared memory.
struct Flags {
  uint32_t* base;   // this lane's column of the interleaved words
  int nwords;
  __device__ __forceinline__ uint32_t* word(int f, int i) const {
    return base + (f * nwords + (i >> 5)) * kLanes;
  }
  __device__ __forceinline__ int get(int f, int i) const {
    return (*word(f, i) >> (i & 31)) & 1;
  }
  __device__ __forceinline__ void set(int f, int i) const {
    *word(f, i) |= 1u << (i & 31);
  }
  __device__ __forceinline__ void clear(int f) const {
    for (int k = 0; k < nwords; ++k) base[(f * nwords + k) * kLanes] = 0u;
  }
};

struct Lane {
  Decoder s;
  Flags f;
  uint8_t* ctx;          // ctx[cx * kLanes]: the lane's context states
  const uint32_t* tbl;
  const uint8_t* zc;     // zc[h * 15 + v * 5 + d] for the lane's orient
  uint32_t* out;         // out[i * B]: the lane's samples
  int B, w, W2;

  __device__ __forceinline__ int dec(int cx) {
    return decode(s, ctx + cx * kLanes, tbl);
  }
  __device__ __forceinline__ int sig(int i) const { return f.get(kSig, i); }

  // the zero-coding context of padded sample i
  __device__ __forceinline__ int zc_ctx(int i) const {
    const int h = sig(i - 1) + sig(i + 1);
    const int v = sig(i - W2) + sig(i + W2);
    const int d = sig(i - W2 - 1) + sig(i - W2 + 1) + sig(i + W2 - 1) +
                  sig(i + W2 + 1);
    return zc[h * 15 + v * 5 + d];
  }
  __device__ __forceinline__ int any_sig(int i) const {
    return sig(i - W2 - 1) | sig(i - W2) | sig(i - W2 + 1) | sig(i - 1) |
           sig(i + 1) | sig(i + W2 - 1) | sig(i + W2) | sig(i + W2 + 1);
  }
  __device__ __forceinline__ int contrib(int i) const {
    return sig(i) ? 1 - 2 * f.get(kNeg, i) : 0;
  }

  // Sign decoding (Table D.3) of sample (y, x), padded index i, which
  // becomes significant in `bit`'s plane.
  __device__ __forceinline__ void sign(int i, int y, int x, uint32_t bit) {
    int hc = contrib(i - 1) + contrib(i + 1);
    int vc = contrib(i - W2) + contrib(i + W2);
    hc = hc < -1 ? -1 : (hc > 1 ? 1 : hc);
    vc = vc < -1 ? -1 : (vc > 1 ? 1 : vc);
    const int spb = hc < 0 || (hc == 0 && vc < 0);
    if (spb) {
      hc = -hc;
      vc = -vc;
    }
    const int off = hc == 1 ? (vc == 1 ? 4 : vc == 0 ? 3 : 2)
                            : (vc == 1 ? 1 : 0);
    const int neg = dec(kCtxSc + off) ^ spb;
    f.set(kSig, i);
    if (neg) f.set(kNeg, i);
    out[static_cast<size_t>(y * w + x) * B] = bit | (neg ? 0x80000000u : 0u);
  }

  // significance propagation over one stripe column
  __device__ __forceinline__ void spp(int y0, int x, int sh, uint32_t bit) {
    for (int k = 0; k < sh; ++k) {
      const int i = (y0 + k + 1) * W2 + x + 1;
      if (sig(i) || !any_sig(i)) continue;
      const int d = dec(zc_ctx(i));
      f.set(kVis, i);
      if (d) sign(i, y0 + k, x, bit);
    }
  }

  // magnitude refinement over one stripe column
  __device__ __forceinline__ void mrp(int y0, int x, int sh, uint32_t bit) {
    for (int k = 0; k < sh; ++k) {
      const int i = (y0 + k + 1) * W2 + x + 1;
      if (!sig(i) || f.get(kVis, i)) continue;
      const int cx = f.get(kRef, i) ? kCtxMag + 2 : kCtxMag + any_sig(i);
      if (dec(cx)) out[static_cast<size_t>((y0 + k) * w + x) * B] |= bit;
      f.set(kRef, i);
    }
  }

  // cleanup over one stripe column, with run-length aggregation on full
  // stripes whose 6 x 3 box holds nothing significant and whose column
  // holds nothing visited
  __device__ __forceinline__ void cln(int y0, int x, int sh, uint32_t bit) {
    const int top = (y0 + 1) * W2 + x + 1;
    int k = 0;
    if (sh == 4) {
      bool agg = true;
      for (int r = -1; r <= 4 && agg; ++r) {
        const int i = top + r * W2;
        agg = !(sig(i - 1) | sig(i) | sig(i + 1));
      }
      for (int r = 0; r < 4 && agg; ++r) agg = !f.get(kVis, top + r * W2);
      if (agg) {
        if (!dec(kCtxRl)) return;   // the column stays insignificant
        int r = dec(kCtxUni) << 1;
        r |= dec(kCtxUni);
        // the run-interrupt sample: significant, no zero-coding decision
        sign(top + r * W2, y0 + r, x, bit);
        k = r + 1;
      }
    }
    for (; k < sh; ++k) {
      const int i = top + k * W2;
      if (sig(i) || f.get(kVis, i)) continue;
      if (dec(zc_ctx(i))) sign(i, y0 + k, x, bit);
    }
  }
};

__global__ void __launch_bounds__(kLanes)
mq_dec_kernel(const uint8_t* __restrict__ data,
              const int64_t* __restrict__ off,
              const int32_t* __restrict__ nbps,
              const int32_t* __restrict__ npas,
              const int32_t* __restrict__ ori, int B, int w, int h,
              int nwords, uint32_t* __restrict__ out,
              int32_t* __restrict__ stats) {
  extern __shared__ uint32_t flags[];   // [kPlanes][nwords][kLanes]
  __shared__ uint32_t tbl[kStates];
  __shared__ uint8_t ctx[kNumCtxs * kLanes];
  __shared__ uint8_t zc[4 * 45];
  const int tid = threadIdx.x;
  for (int i = tid; i < kStates; i += kLanes) tbl[i] = packed_row(i);
  for (int i = tid; i < 4 * 45; i += kLanes)
    zc[i] = static_cast<uint8_t>(zc_rule(i / 45, (i / 15) % 3, (i / 5) % 3,
                                         i % 5));
  for (int i = 0; i < kNumCtxs; ++i) ctx[i * kLanes + tid] = kCtxInit[i];
  Flags f{flags + tid, nwords};
  for (int p = 0; p < kPlanes; ++p) f.clear(p);
  __syncthreads();
  const int b = blockIdx.x * kLanes + tid;
  if (b >= B) return;

  Lane L;
  L.f = f;
  L.ctx = ctx + tid;
  L.tbl = tbl;
  L.zc = zc + 45 * ori[b];
  L.out = out + b;
  L.B = B;
  L.w = w;
  L.W2 = w + 2;
  Decoder& s = L.s;
  s.seg = data + off[b];
  s.end = static_cast<int>(off[b + 1] - off[b]);
  s.pos = 0;
  s.ndec = 0;
  s.nbytein = 0;
  // INITDEC (C.3.5)
  s.c = (s.end > 0 ? static_cast<uint32_t>(s.seg[0]) : 0xFFu) << 16;
  s.ct = 0;
  bytein(s);
  s.c <<= 7;
  s.ct -= 7;
  s.a = 0x8000u;

  // the lane's passes: the cleanup of plane nb - 1, then (SPP, MRP, CLN)
  // per plane below it, down to plane 0 at most
  const int nb = nbps[b];
  const int np = nb > 0 ? min(npas[b], 3 * nb - 2) : 0;
  for (int k = 0; k < np; ++k) {
    const int type = (k + 2) % 3;   // 0 SPP, 1 MRP, 2 CLN
    const uint32_t bit = 1u << (nb - 1 - (k + 2) / 3);
    if (type == 0) L.f.clear(kVis);
    for (int y0 = 0; y0 < h; y0 += 4) {
      const int sh = min(4, h - y0);
      for (int x = 0; x < w; ++x) {
        if (type == 0)
          L.spp(y0, x, sh, bit);
        else if (type == 1)
          L.mrp(y0, x, sh, bit);
        else
          L.cln(y0, x, sh, bit);
      }
    }
  }
  stats[b] = s.ndec;
  stats[B + b] = s.nbytein;
}

}  // namespace

extern "C" {

// data: (N,) uint8; off: (B + 1,) int64; nbps, npas, ori: (B,) int32;
// out: (h*w, B) int32, zeroed; stats: (2, B) int32.
int mq_dec_group(const void* data, const void* off, const void* nbps,
                 const void* npas, const void* ori, int B, int w, int h,
                 void* out, void* stats, void* stream) {
  const int nwords = ((h + 2) * (w + 2) + 31) / 32;
  const int shmem = kPlanes * nwords * kLanes * 4;
  cudaError_t e = cudaFuncSetAttribute(
      mq_dec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mq_dec_kernel<<<(B + kLanes - 1) / kLanes, kLanes, shmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int64_t*>(off),
      static_cast<const int32_t*>(nbps), static_cast<const int32_t*>(npas),
      static_cast<const int32_t*>(ori), B, w, h, nwords,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(stats));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
