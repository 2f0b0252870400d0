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
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "mq_tables.cuh"

namespace {

constexpr int kThreads = 32;   // a block is one warp
constexpr int kLanes = 4;      // lanes a block of the compact scan
constexpr int kTile = 128;     // slot rows a tile
// aligned 8-byte words that cover a tile row's kLanes bytes at any offset
constexpr int kWords = (7 + kLanes + 7) / 8;
constexpr int kRow = 8 * kWords;   // bytes a staged tile row
static_assert(kLanes <= 8, "a staged row is read as at most two words");
constexpr int kCtxRows = 32;   // every 5-bit cx of a slot byte indexes a row
constexpr int kCtxWords = 5;
constexpr int kAhead = 16;     // slots the dense scan loads before coding
constexpr int kChunk = 256;    // steps m8 numbers words within (mq_tables.DENSE_CHUNK)

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

// ENCODE (C.2) of decision d in the context whose word `cw` is at `cp`;
// returns the context's word after it (stored at `cp` where it changed).
template <class Out>
__device__ __forceinline__ uint32_t encode(Coder<Out>& k, int d,
                                           uint32_t cw, uint32_t* cp,
                                           const uint32_t* rows) {
  const uint32_t qe = cw >> 16;
  const int lps = d != static_cast<int>(cw & 1);
  k.a -= qe;
  if (!lps) {
    if (k.a & 0x8000u) {      // MPS without renormalisation
      k.c += qe;
      return cw;
    }
    if (k.a < qe) {
      k.a = qe;
    } else {
      k.c += qe;
    }
  } else {
    if (k.a < qe) {
      k.c += qe;
    } else {
      k.a = qe;
    }
  }
  cw = ctx_next(cw, lps, rows);
  *cp = cw;
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
  return cw;
}

// The end-of-scan state A, C, CT, the delayed byte at rows 0-3 of
// `state`, the context states packed 4 to a word from row `row`.
template <class Out>
__device__ __forceinline__ void store_state(const Coder<Out>& k,
                                            const uint32_t* ctx, int stride,
                                            const uint32_t* rows,
                                            int32_t* state, size_t sB,
                                            int row) {
  state[0] = static_cast<int32_t>(k.a);
  state[sB] = static_cast<int32_t>(k.c);
  state[2 * sB] = k.ct;
  state[3 * sB] = k.last;
  for (int w = 0; w < kCtxWords; ++w) {
    uint32_t word = 0u;
    for (int j = 0; j < 4 && 4 * w + j < kNumCtxs; ++j)
      word |= ctx_state(ctx[(4 * w + j) * stride], rows) << (8 * j);
    state[(row + w) * sB] = static_cast<int32_t>(word);
  }
}

// FLUSH (C.3.4): set the bits of C to the interval's top, two byte-outs,
// then the delayed byte unless it is 0xFF.
template <class Out>
__device__ __forceinline__ void flush(Coder<Out>& k) {
  const uint32_t tempc = k.c + k.a;
  k.c |= 0xFFFFu;
  if (k.c >= tempc) k.c -= 0x8000u;
  k.c <<= k.ct;
  byteout(k);
  k.c <<= k.ct;
  byteout(k);
  if (k.last >= 0 && k.last != 0xFF) k.out.put(static_cast<uint8_t>(k.last));
}

// Stage tile rows [t0, t0 + kTile) of the block's lanes into `raw`: row r
// gets the aligned 8-byte word holding its first lane's byte, and the
// next one where its kLanes bytes cross into it and it starts inside the
// stream. An aligned word that holds a byte of the stream lies inside the
// stream's allocation (PyTorch's are whole multiples of 512 bytes); its
// bytes outside the stream belong to no lane of the block. One commit
// group a tile, empty past the stream's end.
__device__ __forceinline__ void stage_tile(uint8_t (*raw)[kRow],
                                           uintptr_t base, uintptr_t stop,
                                           int T, size_t sB, int t0,
                                           int tid) {
  for (int r = tid; r < kTile; r += kThreads) {
    const int t = t0 + r;
    if (t >= T) break;
    const uintptr_t g = base + static_cast<size_t>(t) * sB;
    const uintptr_t c0 = g & ~uintptr_t{7};
    __pipeline_memcpy_async(raw[r], reinterpret_cast<const void*>(c0), 8);
    if (kWords > 1 && (g & 7) + kLanes > 8 && c0 + 8 < stop)
      __pipeline_memcpy_async(raw[r] + 8,
                              reinterpret_cast<const void*>(c0 + 8), 8);
  }
  __pipeline_commit();
}

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
  stage_tile(raw[0], base, stop, T, sB, 0, tid);
  stage_tile(raw[1], base, stop, T, sB, kTile, tid);
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
      uint64_t v = 0;
      if (t < T) {
        const int s = 8 * static_cast<int>((base + t * sB) & 7);
        const uint64_t* w = reinterpret_cast<const uint64_t*>(tile[r]);
        const uint64_t lo = w[0], hi = kWords > 1 ? w[1] : 0;
        v = s ? (lo >> s) | (hi << (64 - s)) : lo;
      }
      const unsigned below = (1u << tid) - 1;
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        const uint32_t slot = static_cast<uint32_t>(v >> (8 * j)) & 0xFFu;
        const unsigned m = __ballot_sync(0xFFFFFFFFu, slot & 1);
        if (slot & 1)
          list[j][cnt[j] + __popc(m & below)] =
              static_cast<uint16_t>((r << 6) | ((slot >> 1) & 63));
        cnt[j] += __popc(m);
      }
    }
    __syncthreads();
    // the tile after next into the buffer just read
    stage_tile(tile, base, stop, T, sB, t0 + 2 * kTile, tid);
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

// The dense scan: the same coder, with the outputs of every step; one
// thread a lane, kThreads lanes a block.
__global__ void __launch_bounds__(kThreads)
mq_scan_dense_kernel(const uint8_t* __restrict__ slots, int T, int T_out,
                     int B, int32_t* __restrict__ words,
                     int32_t* __restrict__ m8, int32_t* __restrict__ nbo,
                     int32_t* __restrict__ state) {
  __shared__ uint32_t rows[kStates];
  __shared__ uint32_t ctx[kCtxRows][kThreads];
  const int tid = threadIdx.x;
  for (int i = tid; i < kStates; i += kThreads) rows[i] = ctx_row(i);
  for (int i = 0; i < kCtxRows; ++i) ctx[i][tid] = ctx_init(i);
  __syncthreads();
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
      if (ahead[j] & 1) {
        uint32_t* cp = &ctx[(ahead[j] >> 2) & (kCtxRows - 1)][tid];
        encode(k, (ahead[j] >> 1) & 1, *cp, cp, rows);
      }
      const size_t o = static_cast<size_t>(s) * sB + b;
      words[o] = k.out.full ? static_cast<int32_t>(k.out.word) : 0;
      m8[o] = k.out.full ? cnt : -1;
      nbo[o] = k.out.nbo;
      cnt += k.out.full;
    }
  }

  store_state(k, &ctx[0][tid], kThreads, rows, state + b, sB, 6);
  state[4 * sB + b] = static_cast<int32_t>(k.out.wacc);
  state[5 * sB + b] = k.out.wcnt;
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
