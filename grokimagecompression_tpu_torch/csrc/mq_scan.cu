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
// The dense scan (mq_scan_dense) replaces the Pallas TPU kernel
// mq_scan_blocked of the same file (pallas_call at :264; its flat wrapper
// mq_scan at :284), which nothing but the reference's own
// mq_jax.run_mq_scans / run_mq_scans_blocked calls. It runs the same
// coder and writes, for every step of the stream, the 32-bit word
// completed there (bytes little-endian, as mq_jax.mq_step packs them),
// that word's index among the lane's words of its 256-step chunk (-1
// where none) and the step's byte-out count; then the 11-word state of
// the reference (with the partial word and its byte count). The word
// accumulator lives in registers (WordOut below). The TPU kernel's
// (t_pad, S, 128) sublane blocking and its lane-tile x 256-step grid are
// VMEM workarounds and are not carried over: one thread walks its lane's
// whole stream, and the 256-step chunk survives only as the numbering of
// m8. What bounds it: the same dependent coding steps as the compact
// scan, and now 12 output bytes a step and lane (3.35 TB/s moves a
// config-1 64x64 group's 4.6 GB in ~1.4 ms, well under the coder chain);
// the stores are coalesced across a warp's neighbouring lanes.
//
// Plain C interface (bound with ctypes): the entry points launch on the
// given stream and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "mq_tables.cuh"

namespace {

constexpr int kThreads = 32;
constexpr int kCtxRows = 32;  // every 5-bit cx of a slot byte indexes a row
constexpr int kCtxWords = 5;
constexpr int kAhead = 16;   // slots loaded per lane before coding them
constexpr int kChunk = 256;  // steps m8 numbers words within (mq_tables.DENSE_CHUNK)

// Where the coder's bytes go. The compact scan writes them straight to
// the lane's segment.
struct SegmentOut {
  uint8_t* seg;    // the lane's segment
  int n;           // bytes written
  __device__ __forceinline__ void put(uint8_t b) { seg[n++] = b; }
  __device__ __forceinline__ void tick() {}
};

// The dense scan packs them into 32-bit words as the reference's
// mq_jax.mq_step does (byte i of a word at bits 8 i .. 8 i + 7) and
// reports, per step, the word completed and the step's byte-outs.
struct WordOut {
  uint32_t wacc;   // the word being filled
  int wcnt;        // its bytes
  uint32_t word;   // the word this step completed, where `full`
  int full;
  int nbo;         // this step's byte-outs
  __device__ __forceinline__ void put(uint8_t b) {
    wacc |= static_cast<uint32_t>(b) << (8 * wcnt);
    if (++wcnt == 4) {
      word = wacc;
      full = 1;
      wacc = 0u;
      wcnt = 0;
    }
  }
  __device__ __forceinline__ void tick() { ++nbo; }
};

template <class Out>
struct Coder {
  uint32_t a, c;
  int ct, last;    // last: the delayed output byte, -1 before the first
  Out out;
};

// BYTEOUT (C.3.2) with a one-byte delay register: a carry out of C only
// ever reaches the byte written last, which is still held in `last`.
template <class Out>
__device__ __forceinline__ void byteout(Coder<Out>& k) {
  k.out.tick();
  if (k.last == 0xFF) {
    k.out.put(0xFF);
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
        k.out.put(0xFF);
        k.last = (k.c >> 20) & 0xFF;
        k.c &= 0xFFFFF;
        k.ct = 7;
        return;
      }
    }
    k.c &= 0x7FFFFFF;
  }
  if (k.last >= 0) k.out.put(static_cast<uint8_t>(k.last));
  k.last = (k.c >> 19) & 0xFF;
  k.c &= 0x7FFFF;
  k.ct = 8;
}

// ENCODE (C.2) of one emitting slot: decision d in context cx.
template <class Out>
__device__ __forceinline__ void encode(Coder<Out>& k, uint32_t slot,
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

// Context states and Table C.2 into shared memory (every thread of the
// block), as both scans start.
__device__ __forceinline__ void init_shared(uint32_t* tbl,
                                            uint8_t (*ctx)[kThreads],
                                            int tid) {
  for (int i = tid; i < kStates; i += kThreads) tbl[i] = packed_row(i);
  for (int i = 0; i < kCtxRows; ++i)
    ctx[i][tid] = i < kNumCtxs ? kCtxInit[i] : 0;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
mq_scan_kernel(const uint8_t* __restrict__ slots, int T, int B,
               const int64_t* __restrict__ seg_off, uint8_t* __restrict__ out,
               int32_t* __restrict__ lens, int32_t* __restrict__ state,
               int32_t* __restrict__ cumbo, int sa, int sb, int tp) {
  __shared__ uint32_t tbl[kStates];
  __shared__ uint8_t ctx[kCtxRows][kThreads];
  const int tid = threadIdx.x;
  init_shared(tbl, ctx, tid);
  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;

  Coder<SegmentOut> k{0x8000u, 0u, 12, -1, {out + seg_off[b], 0}};
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
      cumbo[row * sB + b] = k.out.n + (k.last >= 0);
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
  if (k.last >= 0 && k.last != 0xFF) k.out.put(static_cast<uint8_t>(k.last));
  lens[b] = k.out.n;
}

// The dense scan: the same coder, with the outputs of every step.
__global__ void __launch_bounds__(kThreads)
mq_scan_dense_kernel(const uint8_t* __restrict__ slots, int T, int T_out,
                     int B, int32_t* __restrict__ words,
                     int32_t* __restrict__ m8, int32_t* __restrict__ nbo,
                     int32_t* __restrict__ state) {
  __shared__ uint32_t tbl[kStates];
  __shared__ uint8_t ctx[kCtxRows][kThreads];
  const int tid = threadIdx.x;
  init_shared(tbl, ctx, tid);
  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;

  Coder<WordOut> k{0x8000u, 0u, 12, -1, {0u, 0, 0u, 0, 0}};
  const size_t sB = static_cast<size_t>(B);
  const uint8_t* col = slots + b;
  int cnt = 0;   // words of the lane in the current 256-step chunk
  for (int t = 0; t < T_out; t += kAhead) {
    uint8_t ahead[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      ahead[j] = t + j < T ? col[static_cast<size_t>(t + j) * sB] : 0;
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int s = t + j;
      if (s >= T_out) break;
      if (s % kChunk == 0) cnt = 0;
      k.out.full = 0;
      k.out.nbo = 0;
      if (ahead[j] & 1) encode(k, ahead[j], ctx, tid, tbl);
      const size_t o = static_cast<size_t>(s) * sB + b;
      words[o] = k.out.full ? static_cast<int32_t>(k.out.word) : 0;
      m8[o] = k.out.full ? cnt : -1;
      nbo[o] = k.out.nbo;
      cnt += k.out.full;
    }
  }

  state[0 * sB + b] = static_cast<int32_t>(k.a);
  state[1 * sB + b] = static_cast<int32_t>(k.c);
  state[2 * sB + b] = k.ct;
  state[3 * sB + b] = k.last;
  state[4 * sB + b] = static_cast<int32_t>(k.out.wacc);
  state[5 * sB + b] = k.out.wcnt;
  for (int w = 0; w < kCtxWords; ++w) {
    uint32_t word = 0u;
    for (int j = 0; j < 4 && 4 * w + j < kNumCtxs; ++j)
      word |= static_cast<uint32_t>(ctx[4 * w + j][tid]) << (8 * j);
    state[(6 + w) * sB + b] = static_cast<int32_t>(word);
  }
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

// The dense scan. slots: (T, B) int8; words, m8, nbo: (T_out, B) int32
// with T_out >= T (rows past T code no-op slots); state: (11, B) int32.
int mq_scan_dense(const void* slots, int T, int T_out, int B, void* words,
                  void* m8, void* nbo, void* state, void* stream) {
  mq_scan_dense_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(slots), T, T_out, B,
      static_cast<int32_t*>(words), static_cast<int32_t*>(m8),
      static_cast<int32_t*>(nbo), static_cast<int32_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
