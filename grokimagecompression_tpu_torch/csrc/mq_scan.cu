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
// sections (sa, sb, sc) of ops/mq_torch.pass_spans_padded.
//
// What bounds it: one lane is one code-block whose coder walks its coding
// slots one dependent step after another (a context word loaded, A and C
// updated, the word stored back on a transition, bytes out), so the
// kernel is bound by the latency of those steps in one thread, not by the
// bytes (a config-1 chunk's 64x64 group is ~0.4 GB of slots, 0.12 ms of
// HBM time). Only ~14 % of a config-1 stream's slots code; a warp that
// walked all T steps together would run the coder at nearly every step,
// since one of its lanes codes there. The design:
//   - kLanes lanes a block of one warp: lanes that share a warp diverge
//     and take turns, while the whole warp stages and compacts their
//     tiles. Fewer lanes a warp shorten the turns where the lanes are few
//     (the coder waits on its chain) and cost issue slots where they are
//     many (the SMs' warps compete): chip_smoke.py builds 8, 4, 2 and 1
//     and times them in turns on a config-1 group (2016 lanes; 1 is
//     fastest) and a config-2 2-frame group (6144 lanes; 4 is fastest),
//     and 4 has the least sum (PERF.md). B = 2016 lanes make 504 blocks
//     over the 132 SMs;
//   - the slots arrive in tiles of kTile = 128 rows x the block's lanes
//     (~6 KB of shared memory a block, so that the blocks of a large
//     group, such as a config-2 chunk's 1536, are all resident), by
//     cp.async into shared memory, double-buffered: the next tile loads
//     while the current one is coded. A tile row's kLanes bytes lie at any
//     alignment (B and the lane offset are arbitrary), so each row copies
//     the one or two aligned 8-byte words that cover them (one where B is
//     a multiple of 8) and the reader shifts them into place;
//   - the whole warp then compacts the tile: per 32 rows, one warp vote
//     per lane gives the rows where that lane codes, and each lane's
//     coding slots go to its own list (row, decision, context) in
//     shared memory. Each lane's thread then codes only its own list: a
//     warp takes max over its lanes of E steps a tile, E being a lane's
//     coding slots there, not kTile steps;
//   - A, C, CT and the delayed byte in registers; each context one word of
//     mq_tables.cuh in shared memory (Table C.2 read only on a
//     transition); the next coding slot and its context word are loaded a
//     step ahead, so the chain waits on a shared load only on a
//     transition; RENORME shifts by the count of leading zeros;
//   - the pass-end byte-outs (rate control) are recorded when a lane's
//     position passes each pass end, before its next coding slot or at the
//     tile's end, passes in which it codes nothing included;
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
// The coder itself, the staging and the compaction are in mq_coder.cuh,
// which the dense scan (mq_dense.cu) shares.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "mq_coder.cuh"

namespace {

constexpr int kThreads = 32;   // a block is one warp
constexpr int kLanes = 4;      // lanes a block of the compact scan
// aligned 8-byte words that cover a tile row's kLanes bytes at any offset
constexpr int kRow = 8 * stage_words<kLanes>();   // bytes a staged tile row
static_assert(kLanes <= 8, "a staged row is read as at most two words");

// Where the coder's bytes go. The compact scan writes them straight to
// the lane's segment.
struct SegmentOut {
  uint8_t* seg;    // the lane's segment
  int n;           // bytes written
  __device__ __forceinline__ void put(uint8_t b) { seg[n++] = b; }
  __device__ __forceinline__ void tick() {}
};

__global__ void __launch_bounds__(kThreads)
mq_scan_kernel(const uint8_t* __restrict__ slots, int T, int B,
               const int64_t* __restrict__ seg_off, uint8_t* __restrict__ out,
               int32_t* __restrict__ lens, int32_t* __restrict__ state,
               int32_t* __restrict__ cumbo, int sa, int sb, int tp) {
  __shared__ __align__(16) uint8_t raw[2][kTile][kRow];
  __shared__ uint16_t list[kLanes][kTile];   // row << 6 | d | cx << 1
  __shared__ uint32_t rows[kStates];
  __shared__ uint32_t ctx[kCtxRows][kLanes];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kLanes;
  const size_t sB = static_cast<size_t>(B);
  const uintptr_t base = reinterpret_cast<uintptr_t>(slots) + b0;
  const uintptr_t stop = reinterpret_cast<uintptr_t>(slots) + T * sB;
  const auto stage = [&](uint8_t (*dst)[kRow], int from) {
    stage_tile<kLanes, kRow, kThreads>(dst, base, stop, T, sB, from, tid);
  };
  stage(raw[0], 0);
  stage(raw[1], kTile);
  for (int i = tid; i < kStates; i += kThreads) rows[i] = ctx_row(i);
  for (int i = tid; i < kCtxRows * kLanes; i += kThreads)
    ctx[i / kLanes][i % kLanes] = ctx_init(i / kLanes);
  __syncthreads();   // the tables, also for a stream of no tile

  // thread tid < kLanes codes lane b; every thread stages and compacts
  const int b = b0 + tid;
  const bool coder = tid < kLanes && b < B;
  uint32_t* lane_ctx = &ctx[0][tid % kLanes];
  Coder<SegmentOut> k{0x8000u, 0u, 12, -1,
                      {coder ? out + seg_off[b] : nullptr, 0}};
  // pass ends of plane q: q tp + sa, q tp + sa + sb, (q + 1) tp
  int prow = 0, end = cumbo && coder ? sa : T + 1;
  const auto passed = [&](int t) {
    while (end <= t) {
      cumbo[prow * sB + b] = k.out.n + (k.last >= 0);
      ++prow;
      const int q = prow / 3, phase = prow % 3;
      end = q * tp + (phase == 0 ? sa : phase == 1 ? sa + sb : tp);
    }
  };

  for (int i = 0, t0 = 0; t0 < T; ++i, t0 += kTile) {
    uint8_t (*tile)[kRow] = raw[i & 1];
    __pipeline_wait_prior(1);
    __syncthreads();
    // compact: per 32 rows, each lane's coding rows by one warp vote
    int cnt[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) cnt[j] = 0;
    for (int r0 = 0; r0 < kTile && t0 + r0 < T; r0 += kThreads) {
      const int r = r0 + tid, t = t0 + r;
      const uint64_t v =
          t < T ? row_bytes<kRow>(tile[r],
                                  static_cast<int>((base + t * sB) & 7))
                : 0;
      uint32_t mask[kLanes];
      compact_group<kLanes>(v, r, tid, &list[0][0], cnt, mask);
    }
    __syncthreads();
    // the tile after next into the buffer just read
    stage(tile, t0 + 2 * kTile);
    if (coder) {
      int e = 0;
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        if (j == tid) e = cnt[j];
      // the lane's offsets into the list and the context words stay in
      // registers: the empty asm keeps the compiler from deriving them
      // again from the thread index on every step
      int li = tid * kTile, ci = tid;
      asm volatile("" : "+r"(li), "+r"(ci));
      const uint16_t* lst = &list[0][0];
      uint32_t* words = &ctx[0][0];
      // the next slot and its context word are loaded a step ahead, off
      // the chain; the word is forwarded where the step changes it
      int ent = e ? lst[li] : 0;
      int wi = ((ent >> 1) & (kCtxRows - 1)) * kLanes + ci;
      uint32_t cw = words[wi];
      for (int n = 1; n <= e; ++n) {
        const int nent = n < e ? lst[li + n] : 0;
        const int nwi = ((nent >> 1) & (kCtxRows - 1)) * kLanes + ci;
        const uint32_t ncw = words[nwi];
        passed(t0 + (ent >> 6));
        const uint32_t after = encode(k, ent & 1, cw, words + wi, rows);
        cw = nwi == wi ? after : ncw;
        wi = nwi;
        ent = nent;
      }
      passed(min(t0 + kTile, T));
    }
  }
  __pipeline_wait_prior(0);
  if (!coder) return;

  store_state(k, lane_ctx, kLanes, rows, state + b, sB, 4);
  flush(k);
  lens[b] = k.out.n;
}

}  // namespace

extern "C" {

// slots: (T, B) int8; seg_off: (B,) int64 byte offsets of the lanes'
// segments in `out`, each region at least 15 E / 7 + 3 bytes; lens: (B,)
// int32; state: (9, B) int32; cumbo: null, or (3 T / tp, B) int32 for the
// byte-outs at the pass ends of planes of tp = sa + sb + sc slots (T a
// multiple of tp).
int mq_scan(const void* slots, int T, int B, const void* seg_off, void* out,
            void* lens, void* state, void* cumbo, int sa, int sb, int tp,
            void* stream) {
  mq_scan_kernel<<<(B + kLanes - 1) / kLanes, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(slots), T, B,
      static_cast<const int64_t*>(seg_off), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(lens), static_cast<int32_t*>(state),
      static_cast<int32_t*>(cumbo), sa, sb, tp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
