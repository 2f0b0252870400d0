// Part-1 MQ coder over a slot stream with dense per-step outputs, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mq_scan_blocked of
// grokimagecompression_tpu/ops/mq_scan_pallas.py (pallas_call at :264; its
// flat wrapper mq_scan at :284), which nothing but the reference's own
// mq_jax.run_mq_scans / run_mq_scans_blocked calls. It runs the coder of
// mq_coder.cuh (the steps of mq_jax.mq_step, bit for bit) and writes, for
// every step of the stream, the 32-bit word completed there (bytes
// little-endian, as mq_jax.mq_step packs them), that word's index among
// the lane's words of its 256-step chunk (-1 where none) and the step's
// byte-out count; then the 11-word state of the reference (with the
// partial word and its byte count). The TPU kernel's (t_pad, S, 128)
// sublane blocking and its lane-tile x 256-step grid are VMEM workarounds
// and are not carried over: the 256-step chunk survives only as the
// numbering of m8.
//
// What bounds it: the same dependent coding steps as the compact scan
// (mq_scan.cu), one chain a lane; and 12 output bytes a step and lane,
// 4.6 GB for a config-1 64x64 group (1.4 ms of HBM time at 3.35 TB/s),
// well under the chain. Only ~14 % of a config-1 lane's slots code, so a
// thread that walked every step of its lane would run the coder at nearly
// every step of its warp (one of 32 lanes codes there). The design:
//   - a block is kWarps warps of kLanes lanes each (kLanes x kWarps lanes
//     a block); tiles of kTile = 128 slot rows of the block's lanes arrive
//     by cp.async into shared memory, double-buffered, as in the compact
//     scan (a row's bytes at any alignment: the aligned 8-byte words that
//     cover them);
//   - each warp compacts its lanes' rows: per 32 rows one warp vote per
//     lane gives the rows where that lane codes (kept, with the count of
//     coding rows before them), and the coding slots go to the lane's own
//     list in shared memory;
//   - thread j < kLanes of each warp codes lane j of the warp, walking only
//     its list, with the compact scan's loop (the next entry and its
//     context word loaded a step ahead; RENORME by the count of leading
//     zeros). For entry n it records the step's byte-outs (0-3), a "word
//     completed" bit and the word's index in the chunk in the entry's own
//     list slot (read a step before), and the completed word beside it.
//     The partial word (wacc, wcnt) and the chunk's word count stay in
//     registers; at most one word completes a step (a step writes at most
//     3 bytes). No accumulator caps, no overflow path;
//   - after each tile the whole block expands it into the dense rows: for
//     row r and lane j, bit r of j's vote says whether the row codes, and
//     the count before it plus the popcount of the vote's bits below r is
//     the row's entry. A coding row writes its entry's word, m8 and nbo,
//     any other row 0, -1 and 0. Consecutive threads take consecutive
//     lanes of a row, so the stores of a row segment are contiguous;
//   - rows T .. T_out - 1 (no-op slots) are expanded the same way, with no
//     coding.
// The trade-off: a row segment of k lanes is 4 k bytes an output, under
// a 32-byte sector below 8 lanes; more lanes a warp widen it but lengthen
// the coder's divergent turns, more warps a block widen it at one barrier
// a tile. chip_smoke.py builds kLanes in {1, 2, 4, 8} x kWarps in {1, 4,
// 8} and times them in turns on a config-1 group (2016 lanes: 1 x 8
// fastest, 2 x 8 within 12 %) and a config-2 2-frame group (6144 lanes:
// 2 x 8 fastest); 2 x 8 has the least sum (PERF.md). A block is then 16
// lanes and 256 threads: B = 2016 lanes make 126 blocks, one an SM.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream and returns the first CUDA error.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "mq_coder.cuh"

namespace {

constexpr int kLanes = 2;      // lanes a warp: one coder thread each
constexpr int kWarps = 8;      // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockLanes = kLanes * kWarps;
constexpr int kGroups = kTile / 32;   // vote groups a tile
// a staged row: the words that cover the block's lanes, and one spare so
// that a warp's 8-byte window of its lanes never leaves the row
constexpr int kRow = 8 * (stage_words<kBlockLanes>() + 1);
// steps m8 numbers words within (mq_tables.DENSE_CHUNK)
constexpr int kChunk = 256;
static_assert(kLanes <= 8, "a warp reads its lanes' slots as 8 bytes");
static_assert(kChunk % kTile == 0, "a chunk is whole tiles");
static_assert((kBlockLanes & (kBlockLanes - 1)) == 0,
              "the expansion splits an index by shifts");

// The coder's bytes packed into 32-bit words as the reference's
// mq_jax.mq_step does (byte i of a word at bits 8 i .. 8 i + 7), with the
// word completed and the byte-outs of the current step.
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

// A block's shared memory (dynamic: the widest trials pass 48 KB; the
// shipped 2 x 8 takes 23 KB).
struct Smem {
  uint8_t raw[2][kTile][kRow];   // staged slot rows, double-buffered
  // a lane's coding slots (row << 6 | d | cx << 1), each replaced once
  // coded by its record nbo | full << 2 | m8 << 3
  uint16_t list[kBlockLanes][kTile];
  uint32_t word[kBlockLanes][kTile];   // the word an entry completed
  uint32_t vote[kGroups][kBlockLanes];   // a lane's coding rows of 32
  uint32_t before[kGroups][kBlockLanes];   // its entries before them
  uint32_t ctx[kCtxRows][kBlockLanes];
  uint32_t rows[kStates];
};

__global__ void __launch_bounds__(kThreads)
mq_dense_kernel(const uint8_t* __restrict__ slots, int T, int T_out, int B,
                int32_t* __restrict__ words, int32_t* __restrict__ m8,
                int32_t* __restrict__ nbo, int32_t* __restrict__ state) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kBlockLanes;
  const size_t sB = static_cast<size_t>(B);
  const uintptr_t base = reinterpret_cast<uintptr_t>(slots) + b0;
  const uintptr_t stop = reinterpret_cast<uintptr_t>(slots) + T * sB;
  const auto stage = [&](uint8_t (*dst)[kRow], int from) {
    stage_tile<kBlockLanes, kRow, kThreads>(dst, base, stop, T, sB, from,
                                            tid);
  };
  stage(s.raw[0], 0);
  stage(s.raw[1], kTile);
  for (int i = tid; i < kStates; i += kThreads) s.rows[i] = ctx_row(i);
  for (int i = tid; i < kCtxRows * kBlockLanes; i += kThreads)
    s.ctx[i / kBlockLanes][i % kBlockLanes] = ctx_init(i / kBlockLanes);
  __syncthreads();   // the tables, also for a stream of no tile

  // warp w compacts lanes l0 .. l0 + kLanes - 1 of the block; its thread
  // `lane` < kLanes codes lane l0 + lane
  const int l0 = warp * kLanes;
  const int l = l0 + (lane < kLanes ? lane : 0);
  const bool coder = lane < kLanes && b0 + l < B;
  Coder<WordOut> k{0x8000u, 0u, 12, -1, {0u, 0, 0u, 0, 0}};
  int wc = 0;   // the lane's words in the current chunk

  for (int i = 0, t0 = 0; t0 < T_out; ++i, t0 += kTile) {
    uint8_t (*tile)[kRow] = s.raw[i & 1];
    __pipeline_wait_prior(1);
    __syncthreads();
    // compact: per 32 rows, each lane's coding rows by one warp vote
    int cnt[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) cnt[j] = 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int r = 32 * g + lane, t = t0 + r;
      const uint64_t v =
          t < T ? row_bytes<kRow>(tile[r],
                                  static_cast<int>((base + t * sB) & 7) + l0)
                : 0;
      uint32_t vote[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) s.before[g][l0 + j] = cnt[j];
      compact_group<kLanes>(v, r, lane, &s.list[l0][0], cnt, vote);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) s.vote[g][l0 + j] = vote[j];
    }
    __syncthreads();
    // the tile after next into the buffer just read
    stage(tile, t0 + 2 * kTile);
    if (coder) {
      if (t0 % kChunk == 0) wc = 0;
      int e = 0;
#pragma unroll
      for (int j = 0; j < kLanes; ++j)
        if (j == lane) e = cnt[j];
      // the lane's offsets stay in registers (see mq_scan.cu)
      int li = l * kTile, ci = l;
      asm volatile("" : "+r"(li), "+r"(ci));
      uint16_t* lst = &s.list[0][0];
      uint32_t* wout = &s.word[0][0];
      uint32_t* cws = &s.ctx[0][0];
      int ent = e ? lst[li] : 0;
      int wi = ((ent >> 1) & (kCtxRows - 1)) * kBlockLanes + ci;
      uint32_t cw = cws[wi];
      for (int n = 0; n < e; ++n) {
        const int nent = n + 1 < e ? lst[li + n + 1] : 0;
        const int nwi = ((nent >> 1) & (kCtxRows - 1)) * kBlockLanes + ci;
        const uint32_t ncw = cws[nwi];
        k.out.full = 0;
        k.out.nbo = 0;
        const uint32_t after = encode(k, ent & 1, cw, cws + wi, s.rows);
        lst[li + n] =
            static_cast<uint16_t>(k.out.nbo | (k.out.full << 2) | (wc << 3));
        if (k.out.full) wout[li + n] = k.out.word;
        wc += k.out.full;
        cw = nwi == wi ? after : ncw;
        wi = nwi;
        ent = nent;
      }
    }
    __syncthreads();
    // expand the tile into rows t0 .. t0 + kTile - 1 of every lane
    for (int x = tid; x < kTile * kBlockLanes; x += kThreads) {
      const int r = x / kBlockLanes, j = x % kBlockLanes, t = t0 + r;
      if (t >= T_out) break;
      if (b0 + j >= B) continue;
      const uint32_t vote = s.vote[r >> 5][j];
      const int bit = r & 31;
      int32_t w = 0, c = -1, n = 0;
      if ((vote >> bit) & 1) {
        const int e = s.before[r >> 5][j] + __popc(vote & ((1u << bit) - 1));
        const int rec = s.list[j][e];
        n = rec & 3;
        if (rec & 4) {
          w = static_cast<int32_t>(s.word[j][e]);
          c = rec >> 3;
        }
      }
      const size_t o = static_cast<size_t>(t) * sB + b0 + j;
      words[o] = w;
      m8[o] = c;
      nbo[o] = n;
    }
  }
  __pipeline_wait_prior(0);
  if (!coder) return;

  const size_t b = static_cast<size_t>(b0 + l);
  store_state(k, &s.ctx[0][l], kBlockLanes, s.rows, state + b, sB, 6);
  state[4 * sB + b] = static_cast<int32_t>(k.out.wacc);
  state[5 * sB + b] = k.out.wcnt;
}

}  // namespace

extern "C" {

// The dense scan. slots: (T, B) int8; words, m8, nbo: (T_out, B) int32
// with T_out >= T (rows past T code no-op slots); state: (11, B) int32.
int mq_scan_dense(const void* slots, int T, int T_out, int B, void* words,
                  void* m8, void* nbo, void* state, void* stream) {
  if (sizeof(Smem) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mq_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mq_dense_kernel<<<(B + kBlockLanes - 1) / kBlockLanes, kThreads,
                    sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(slots), T, T_out, B,
      static_cast<int32_t*>(words), static_cast<int32_t*>(m8),
      static_cast<int32_t*>(nbo), static_cast<int32_t*>(state));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
