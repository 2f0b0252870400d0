// The Part-1 MQ coder shared by the two MQ scan kernels (mq_scan.cu: the
// compact scan; mq_dense.cu: the dense-output scan): the coder's state and
// its ENCODE, BYTEOUT and FLUSH procedures (Annex C), the end-of-scan state
// words, the cp.async staging of a tile of slot rows, and the per-32-row
// compaction of a warp's lanes into lists of coding slots. The coding steps
// are those of mq_jax.mq_step, bit for bit. Where a step's bytes go is the
// including kernel's `Out` type:
//   put(b)  a byte written (after the one-byte delay);
//   tick()  a byte-out, the lane's first included (which writes no byte).

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "mq_tables.cuh"

namespace {

constexpr int kTile = 128;     // slot rows a tile
constexpr int kCtxRows = 32;   // every 5-bit cx of a slot byte indexes a row
constexpr int kCtxWords = 5;

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

// Aligned 8-byte words that cover `Lanes` consecutive slot bytes at any
// offset.
template <int Lanes>
__host__ __device__ constexpr int stage_words() {
  return (7 + Lanes + 7) / 8;
}

// Stage tile rows [t0, t0 + kTile) of `Lanes` lanes from `base` into
// `raw` (rows of Row bytes), `Threads` threads: row r gets the aligned
// 8-byte word holding its first lane's byte, and each next one that its
// Lanes bytes cross into, where it starts inside the stream. An aligned
// word that holds a byte of the stream lies inside the stream's
// allocation (PyTorch's are whole multiples of 512 bytes); its bytes
// outside the stream belong to no lane of the block. One commit group a
// tile, empty past the stream's end.
template <int Lanes, int Row, int Threads>
__device__ __forceinline__ void stage_tile(uint8_t (*raw)[Row],
                                           uintptr_t base, uintptr_t stop,
                                           int T, size_t sB, int t0,
                                           int tid) {
  constexpr int kWords = stage_words<Lanes>();
  static_assert(Row >= 8 * kWords, "a staged row holds its words");
  for (int r = tid; r < kTile; r += Threads) {
    const int t = t0 + r;
    if (t >= T) break;
    const uintptr_t g = base + static_cast<size_t>(t) * sB;
    const uintptr_t c0 = g & ~uintptr_t{7};
    __pipeline_memcpy_async(raw[r], reinterpret_cast<const void*>(c0), 8);
#pragma unroll
    for (int w = 1; w < kWords; ++w)
      if ((g & 7) + Lanes > 8 * w && c0 + 8 * w < stop)
        __pipeline_memcpy_async(raw[r] + 8 * w,
                                reinterpret_cast<const void*>(c0 + 8 * w),
                                8);
  }
  __pipeline_commit();
}

// The 8 slot bytes from byte `s` of a staged row of Row bytes (a row of 8
// bytes holds its lanes in its first word).
template <int Row>
__device__ __forceinline__ uint64_t row_bytes(const uint8_t* row, int s) {
  const uint64_t* w = reinterpret_cast<const uint64_t*>(row) + (s >> 3);
  const int sh = 8 * (s & 7);
  const uint64_t hi = Row > 8 ? w[1] : 0;
  return sh ? (w[0] >> sh) | (hi << (64 - sh)) : w[0];
}

// Compact one group of 32 rows of a warp's `Lanes` lanes: the thread of
// warp lane `tid` holds row `r`'s slot bytes in `v` (0 past the stream).
// For each lane j, one warp vote gives the rows where it codes (`mask[j]`);
// each coding slot goes to list[j * kTile + cnt[j] + its rank among them]
// as r << 6 | d | cx << 1, and cnt[j] grows by the group's coding slots.
template <int Lanes>
__device__ __forceinline__ void compact_group(uint64_t v, int r, int tid,
                                              uint16_t* list, int* cnt,
                                              uint32_t* mask) {
  const unsigned below = (1u << tid) - 1;
#pragma unroll
  for (int j = 0; j < Lanes; ++j) {
    const uint32_t slot = static_cast<uint32_t>(v >> (8 * j)) & 0xFFu;
    const unsigned m = __ballot_sync(0xFFFFFFFFu, slot & 1);
    if (slot & 1)
      list[j * kTile + cnt[j] + __popc(m & below)] =
          static_cast<uint16_t>((r << 6) | ((slot >> 1) & 63));
    cnt[j] += __popc(m);
    mask[j] = m;
  }
}

}  // namespace
