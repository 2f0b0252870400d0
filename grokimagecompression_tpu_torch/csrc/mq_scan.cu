// Part-1 MQ arithmetic coder over a slot stream, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mq_scan_compact_blocked of
// grokimagecompression_tpu/ops/mq_scan_pallas.py (pallas_call at :188),
// together with the host FLUSH and splice that follow it
// (ops/mq_jax.py flush_tail, assemble_mq_segments). The coding steps are
// those of mq_jax.mq_step, bit for bit.
//
// Input: a (T, B) int8 slot stream, lanes last; slot = emit | d<<1 |
// cx<<2. A slot with emit = 0 is a pure passthrough. Output: each lane's
// complete codeword segment (the bytes of the scan, then the FLUSH tail
// with the trailing 0xFF dropped), written at the lane's own offset in
// one byte buffer, its length, and the coder state at the end of the
// scan (A, C, CT, the delayed byte, the five packed context words).
// Optionally (rate control, the reference's want_rd tables) also the
// byte-out count at the end of every coding pass: the length the host
// coder's buffer has reached there, the n bytes written plus the byte
// still held in the delay register. The passes of a plane are the stream
// sections (sa, sb, sc) of ops/mq_torch.pass_spans_padded, each a
// multiple of 256 slots, so every pass end falls on a 16-slot load group.
//
// What bounds it: one lane is one code-block whose coder walks its slots
// one dependent step after another, so the kernel is bound by the latency
// of those steps in one thread, not by the bytes (a config-1 chunk's
// 64x64 group is ~0.5 GB of slots, 0.15 ms of HBM time). The design:
//   - one thread per lane, A/C/CT/the delayed byte in registers, the 19
//     context states as bytes in shared memory (one column per thread),
//     Table C.2 in shared memory (the lookups diverge across a warp);
//   - slots are read lanes-last, so a warp reads 32 neighbouring bytes a
//     step; they are loaded 16 steps at a time ahead of the coding, and
//     emit = 0 slots are skipped by a branch (most of a stream is padding
//     and positions that code nothing); no activity map, no 128-lane
//     blocking;
//   - bytes go straight to the lane's segment: no word accumulator, no
//     compaction caps, no overflow flag. The wrapper lays the segments out
//     by an exact bound (below), so a lane can never overflow;
//   - the FLUSH runs here at the lane's end, so the host gets finished
//     segments.
//
// Bound on a lane's bytes, from its count E of emitting slots: one
// decision renormalises by at most 15 bits (the smallest Qe is 0x0001),
// and a byte-out needs CT shifts, CT = 12 at the start and 7 or 8 after
// every byte-out, so the scan does at most floor(15 E / 7) byte-outs of
// one byte each; FLUSH writes at most 3 more. Bound: 15 E / 7 + 3.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "mq_tables.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kCtxRows = 32;  // every 5-bit cx of a slot byte indexes a row
constexpr int kCtxWords = 5;
constexpr int kAhead = 16;   // slots loaded per lane before coding them

struct Coder {
  uint32_t a, c;
  int ct, last;    // last: the delayed output byte, -1 before the first
  uint8_t* seg;    // the lane's segment
  int n;           // bytes written
};

// BYTEOUT (C.3.2) with a one-byte delay register: a carry out of C only
// ever reaches the byte written last, which is still held in `last`.
__device__ __forceinline__ void byteout(Coder& k) {
  if (k.last == 0xFF) {
    k.seg[k.n++] = 0xFF;
    k.last = (k.c >> 20) & 0xFF;
    k.c &= 0xFFFFF;
    k.ct = 7;
    return;
  }
  if (k.c > 0x7FFFFFFu) {
    if (k.last >= 0) {
      k.last += 1;
      if (k.last == 0xFF) {
        k.c &= 0x7FFFFFF;
        k.seg[k.n++] = 0xFF;
        k.last = (k.c >> 20) & 0xFF;
        k.c &= 0xFFFFF;
        k.ct = 7;
        return;
      }
    }
    k.c &= 0x7FFFFFF;
  }
  if (k.last >= 0) k.seg[k.n++] = static_cast<uint8_t>(k.last);
  k.last = (k.c >> 19) & 0xFF;
  k.c &= 0x7FFFF;
  k.ct = 8;
}

// ENCODE (C.2) of one emitting slot: decision d in context cx.
__device__ __forceinline__ void encode(Coder& k, uint32_t slot,
                                       uint8_t (*ctx)[kThreads], int tid,
                                       const uint32_t* tbl) {
  const int d = (slot >> 1) & 1;
  const int cx = (slot >> 2) & (kCtxRows - 1);
  const int p = ctx[cx][tid];
  const int mps = p & 1;
  const uint32_t row = tbl[p >> 1];
  const uint32_t qe = row >> 13;
  k.a -= qe;
  if (d == mps) {
    if (k.a & 0x8000u) {      // MPS without renormalisation
      k.c += qe;
      return;
    }
    if (k.a < qe) {
      k.a = qe;
    } else {
      k.c += qe;
    }
    ctx[cx][tid] = static_cast<uint8_t>((((row >> 7) & 63) << 1) | mps);
  } else {
    if (k.a < qe) {
      k.c += qe;
    } else {
      k.a = qe;
    }
    const int sw = row & 1;
    ctx[cx][tid] =
        static_cast<uint8_t>((((row >> 1) & 63) << 1) | (sw ? 1 - mps : mps));
  }
  // RENORME: A is in [1, 0xFFFF]; shift until its bit 15 is set
  int sh = __clz(static_cast<int>(k.a)) - 16;
  k.a <<= sh;
  while (sh > 0) {
    const int s = sh < k.ct ? sh : k.ct;
    k.c <<= s;
    k.ct -= s;
    sh -= s;
    if (k.ct == 0) byteout(k);
  }
}

__global__ void __launch_bounds__(kThreads)
mq_scan_kernel(const uint8_t* __restrict__ slots, int T, int B,
               const int64_t* __restrict__ seg_off, uint8_t* __restrict__ out,
               int32_t* __restrict__ lens, int32_t* __restrict__ state,
               int32_t* __restrict__ cumbo, int sa, int sb, int tp) {
  __shared__ uint32_t tbl[kStates];
  __shared__ uint8_t ctx[kCtxRows][kThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < kStates; i += kThreads) tbl[i] = packed_row(i);
  for (int i = 0; i < kCtxRows; ++i)
    ctx[i][tid] = i < kNumCtxs ? kCtxInit[i] : 0;
  __syncthreads();
  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;

  Coder k{0x8000u, 0u, 12, -1, out + seg_off[b], 0};
  const size_t sB = static_cast<size_t>(B);
  const uint8_t* col = slots + b;
  // pass ends of plane q: q tp + sa, q tp + sa + sb, (q + 1) tp
  int row = 0, end = cumbo ? sa : -1;
  int t = 0;
  for (; t + kAhead <= T; t += kAhead) {
    uint8_t ahead[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) ahead[j] = col[(t + j) * sB];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (ahead[j] & 1) encode(k, ahead[j], ctx, tid, tbl);
    if (t + kAhead == end) {
      cumbo[row * sB + b] = k.n + (k.last >= 0);
      ++row;
      const int q = row / 3, phase = row % 3;
      end = q * tp + (phase == 0 ? sa : phase == 1 ? sa + sb : tp);
    }
  }
  for (; t < T; ++t) {
    const uint8_t s = col[t * sB];
    if (s & 1) encode(k, s, ctx, tid, tbl);
  }

  state[0 * sB + b] = static_cast<int32_t>(k.a);
  state[1 * sB + b] = static_cast<int32_t>(k.c);
  state[2 * sB + b] = k.ct;
  state[3 * sB + b] = k.last;
  for (int w = 0; w < kCtxWords; ++w) {
    uint32_t word = 0u;
    for (int j = 0; j < 4 && 4 * w + j < kNumCtxs; ++j)
      word |= static_cast<uint32_t>(ctx[4 * w + j][tid]) << (8 * j);
    state[(4 + w) * sB + b] = static_cast<int32_t>(word);
  }

  // FLUSH (C.3.4): set the bits of C to the interval's top, two
  // byte-outs, then the delayed byte unless it is 0xFF
  const uint32_t tempc = k.c + k.a;
  k.c |= 0xFFFFu;
  if (k.c >= tempc) k.c -= 0x8000u;
  k.c <<= k.ct;
  byteout(k);
  k.c <<= k.ct;
  byteout(k);
  if (k.last >= 0 && k.last != 0xFF) k.seg[k.n++] = static_cast<uint8_t>(k.last);
  lens[b] = k.n;
}

}  // namespace

extern "C" {

// slots: (T, B) int8; seg_off: (B,) int64 byte offsets of the lanes'
// segments in `out`, each region at least 15 E / 7 + 3 bytes; lens: (B,)
// int32; state: (9, B) int32; cumbo: null, or (3 T / tp, B) int32 for the
// byte-outs at the pass ends of planes of tp = sa + sb + sc slots (T a
// multiple of tp; sa, sb, tp multiples of 16).
int mq_scan(const void* slots, int T, int B, const void* seg_off, void* out,
            void* lens, void* state, void* cumbo, int sa, int sb, int tp,
            void* stream) {
  mq_scan_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(slots), T, B,
      static_cast<const int64_t*>(seg_off), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(lens), static_cast<int32_t*>(state),
      static_cast<int32_t*>(cumbo), sa, sb, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
