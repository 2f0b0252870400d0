// HT cleanup-pass decoder for a group of same-size code-blocks, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of grokimagecompression_tpu/ops/
// ht_dec_pallas.py (_pallas_group_decoder, pallas_call at :490, reached
// through decode_group_pallas). It computes what that kernel and its
// lax.scan twin ht_dec_jax.decode_group_core compute, bit for bit, and
// what ops/ht_dec_torch.decode_group_plain spells out step by step.
//
// One code-block is one lane, one lane is one thread. A thread walks the
// T = ceil(w/4) * ceil(h/2) steps of its block row-pair-major, two quads a
// step: CxtVLC decode of each quad through a 1024-entry LUT, the MEL run
// decoder for all-zero-context quads, the UVLC code of the pair, then the
// eight MagSgn samples. Every step depends on the one before through the
// three stream offsets, so the kernel is bound by the latency of that
// chain inside one thread, not by bytes or operations:
//   - the coder state lives in registers: VLC, MEL and MagSgn bit offsets,
//     MEL k and run, c_p and the line-state snapshot ls0;
//   - the line state (significance and exponent of the row above, qw + 4
//     entries) lives in shared memory, one column per thread, and the two
//     decode LUTs (8 KB) in shared memory per block;
//   - a stream read is two 32-bit loads from the lane's column of the
//     lanes-last word matrix at the word index clamped to W-2 (the last
//     two words hold the stream's pad), in place of the TPU kernel's
//     96-bit windows refilled by one-hot select-and-reduce;
//   - magnitudes and signs go straight to the (B, 2*ny, 4*nx) grid, with
//     no (T, 8, B) transpose, and the lanes are not padded to 128;
//   - small blocks (32 threads) spread a group's lanes over many SMs.
// Magnitudes are the centred (v+2)>>1 form in uint32 arithmetic, so they
// stay below 2^31 and leave as int32.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

struct Words {
  const uint32_t* __restrict__ p;
  int W;       // rows (stream words)
  int B;       // lanes
};

__device__ __forceinline__ void load2(const Words& s, int lane, int off,
                                      uint32_t& w0, uint32_t& w1) {
  const int wi = min(off >> 5, s.W - 2);
  w0 = s.p[static_cast<size_t>(wi) * s.B + lane];
  w1 = s.p[static_cast<size_t>(wi + 1) * s.B + lane];
}

// next 32 stream bits at bit offset `off`, LSB-aligned (VLC, MagSgn)
__device__ __forceinline__ uint32_t fetch_lsb(const Words& s, int lane,
                                              int off) {
  uint32_t w0, w1;
  load2(s, lane, off, w0, w1);
  const uint32_t sh = off & 31;
  return (w0 >> sh) | (sh ? (w1 << (32u - sh)) : 0u);
}

// next 32 stream bits at bit offset `off`, MSB-aligned (MEL)
__device__ __forceinline__ uint32_t fetch_msb(const Words& s, int lane,
                                              int off) {
  uint32_t w0, w1;
  load2(s, lane, off, w0, w1);
  const uint32_t sh = off & 31;
  return (w0 << sh) | (sh ? (w1 >> (32u - sh)) : 0u);
}

__device__ __forceinline__ int mel_exp(int k) {
  return k < 3 ? 0 : k < 6 ? 1 : k < 9 ? 2 : k < 11 ? 3 : k < 12 ? 4 : 5;
}

// one MEL run: updates run, off, k
__device__ __forceinline__ void mel_get_run(const Words& mel, int lane,
                                            int& run, int& off, int& k) {
  const uint32_t win = fetch_msb(mel, lane, off);
  const int e = mel_exp(k);
  if (win >> 31) {
    run = ((1 << e) - 1) << 1;
    k = min(k + 1, 12);
    off += 1;
  } else {
    const uint32_t rest = e > 0 ? (win << 1) >> (32 - e) : 0u;
    run = (static_cast<int>(rest) << 1) + 1;
    k = max(k - 1, 0);
    off += e + 1;
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
// (y0, x0); returns the bottom-left / bottom-right significance and
// exponents for the line state.
__device__ __forceinline__ void decode_quad(
    const Words& ms, int lane, int qf, int U_p, int& ms_off,
    int32_t* __restrict__ mags, int32_t* __restrict__ signs, int W4,
    int y0, int x0, bool& bl_s, int& bl_e, bool& br_s, int& br_e) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const bool sig = (qf >> (4 + n)) & 1;
    uint32_t mag = 0u, sign = 0u, v = 0u;
    if (sig) {
      const uint32_t win = fetch_lsb(ms, lane, ms_off);
      const uint32_t m_n = static_cast<uint32_t>(U_p - ((qf >> (12 + n)) & 1));
      const uint32_t mask = m_n < 32 ? (1u << m_n) - 1u : 0xFFFFFFFFu;
      v = (win & mask) | (static_cast<uint32_t>((qf >> (8 + n)) & 1)
                          << (m_n & 31)) | 1u;
      ms_off += static_cast<int>(m_n);
      mag = (v + 2u) >> 1;
      sign = win & 1u;
    }
    const size_t at = static_cast<size_t>(y0 + (n & 1)) * W4 + x0 + (n >> 1);
    mags[at] = static_cast<int32_t>(mag);
    signs[at] = static_cast<int32_t>(sign);
    if (n == 1) { bl_s = sig; bl_e = bit_length(v); }
    if (n == 3) { br_s = sig; br_e = bit_length(v); }
  }
}

__device__ __forceinline__ int c_p_of(int qf, bool row0) {
  return row0 ? ((qf & 0x10) >> 4) | ((qf & 0xE0) >> 5)
              : ((qf & 0x40) >> 5) | ((qf & 0x80) >> 6);
}

__global__ void __launch_bounds__(kThreads)
ht_dec_kernel(Words mel, Words vlc, Words ms, int B, int w, int h,
              const int32_t* __restrict__ dec0_g,
              const int32_t* __restrict__ dec1_g,
              int32_t* __restrict__ mags, int32_t* __restrict__ signs) {
  extern __shared__ int32_t smem[];
  int32_t* dec0 = smem;
  int32_t* dec1 = smem + 1024;
  int32_t* ls = smem + 2048;           // (qw + 4) x blockDim, per thread
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) {
    dec0[i] = dec0_g[i];
    dec1[i] = dec1_g[i];
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  const int nx = (w + 3) / 4, ny = (h + 1) / 2;
  const int qw = (w + 1) / 2;
  const int W4 = 4 * nx;
  const int stride = blockDim.x;
  int32_t* lst = ls + threadIdx.x;
#define LS(i) lst[(i) * stride]
  for (int i = 0; i < qw + 4; ++i) LS(i) = 0;
  int32_t* gm = mags + static_cast<size_t>(lane) * (2 * ny) * W4;
  int32_t* gs = signs + static_cast<size_t>(lane) * (2 * ny) * W4;

  int mel_run = 0, mel_off = 0, mel_k = 0;
  mel_get_run(mel, lane, mel_run, mel_off, mel_k);
  int vlc_off = 0, ms_off = 0, c_p = 0, ls0 = 0;

  for (int iy = 0; iy < ny; ++iy) {
    const bool row0 = iy == 0;
    const int32_t* dec = row0 ? dec0 : dec1;
    ls0 = LS(0);
    LS(0) = 0;
    c_p = 0;
    for (int ix = 0; ix < nx; ++ix) {
      const int x = 4 * ix;
      const int q = x >> 1;
      const bool has_q1 = x + 2 < w;
      const int ls_q1 = LS(q + 1), ls_q2 = LS(q + 2);

      // quad 0
      const int cq0 = row0 ? c_p : c_p | (ls0 >> 7) | ((ls_q1 >> 5) & 4);
      int qf0 = dec[(cq0 << 7) | (fetch_lsb(vlc, lane, vlc_off) & 0x7F)];
      if (cq0 == 0) {
        mel_run -= 2;
        if (mel_run != -1) qf0 = 0;
        if (mel_run < 0) mel_get_run(mel, lane, mel_run, mel_off, mel_k);
      }
      c_p = c_p_of(qf0, row0);
      vlc_off += qf0 & 0x7;

      // quad 1
      int qf1 = 0;
      if (has_q1) {
        const int cq1 = row0 ? c_p : c_p | (ls_q1 >> 7) | ((ls_q2 >> 5) & 4);
        qf1 = dec[(cq1 << 7) | (fetch_lsb(vlc, lane, vlc_off) & 0x7F)];
        if (cq1 == 0) {
          mel_run -= 2;
          if (mel_run != -1) qf1 = 0;
          if (mel_run < 0) mel_get_run(mel, lane, mel_run, mel_off, mel_k);
        }
        c_p = c_p_of(qf1, row0);
        vlc_off += qf1 & 0x7;
      }

      // u values
      int mode = ((qf0 & 0x8) >> 3) | ((qf1 & 0x8) >> 2);
      if (row0 && mode == 3) {
        mel_run -= 2;
        if (mel_run == -1) mode += 1;
        if (mel_run < 0) mel_get_run(mel, lane, mel_run, mel_off, mel_k);
      }
      int u0, u1, c_u;
      uvlc_decode(fetch_lsb(vlc, lane, vlc_off), mode, row0, u0, u1, c_u);
      vlc_off += c_u;
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

      // samples and line-state writes
      bool bl_s0, br_s0, bl_s1, br_s1;
      int bl_e0, br_e0, bl_e1, br_e1;
      decode_quad(ms, lane, qf0, U_p0, ms_off, gm, gs, W4, 2 * iy, x,
                  bl_s0, bl_e0, br_s0, br_e0);
      decode_quad(ms, lane, qf1, U_p1, ms_off, gm, gs, W4, 2 * iy, x + 2,
                  bl_s1, bl_e1, br_s1, br_e1);
      const int ent_q = LS(q);
      if (bl_s0) LS(q) = (ent_q & 0x80) | 0x80 | max(ent_q & 0x7F, bl_e0);
      int e_q1 = br_s0 ? 0x80 | br_e0 : 0;
      if (bl_s1) e_q1 = (e_q1 & 0x80) | 0x80 | max(e_q1 & 0x7F, bl_e1);
      LS(q + 1) = e_q1;
      LS(q + 2) = (br_s1 && has_q1) ? 0x80 | br_e1 : 0;
    }
  }
#undef LS
}

}  // namespace

extern "C" {

// mel/vlc/ms: (wm_*, B) uint32 lanes-last stream words; dec0/dec1: (1024,)
// int32 LUTs; mags/signs: (B, 2*ny, 4*nx) int32 outputs.
int ht_dec_group(const void* mel, const void* vlc, const void* ms,
                 int wm_mel, int wm_vlc, int wm_ms, int B, int w, int h,
                 const void* dec0, const void* dec1, void* mags, void* signs,
                 void* stream) {
  const int qw = (w + 1) / 2;
  const size_t smem = (2048 + static_cast<size_t>(qw + 4) * kThreads)
                      * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ht_dec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Words m{static_cast<const uint32_t*>(mel), wm_mel, B};
  const Words v{static_cast<const uint32_t*>(vlc), wm_vlc, B};
  const Words s{static_cast<const uint32_t*>(ms), wm_ms, B};
  ht_dec_kernel<<<(B + kThreads - 1) / kThreads, kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      m, v, s, B, w, h, static_cast<const int32_t*>(dec0),
      static_cast<const int32_t*>(dec1), static_cast<int32_t*>(mags),
      static_cast<int32_t*>(signs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
