// Part-1 MQ coder tables shared by the MQ kernels (mq_scan.cu, mq_dec.cu):
// Table C.2, the initial context states of Annex D, and the context word
// the kernels keep per context. Each translation unit gets its own copy in
// constant memory (internal linkage). ops/mq_tables.py holds the same
// values for the torch side.

#pragma once

#include <cstdint>

namespace {

constexpr int kNumCtxs = 19;
constexpr int kStates = 47;

struct QeRow {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

// Table C.2: (Qe, NMPS, NLPS, SWITCH).
__constant__ QeRow kTable[kStates] = {
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

// Initial context states (Annex D), (index << 1) | mps: ZC context 0 at
// state 4, RL at 3, UNI at 46, every other context at 0.
__constant__ uint8_t kCtxInit[kNumCtxs] = {8, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                           0, 0, 0, 0, 0, 0, 0, 6, 92};

// The context word: a context's Table C.2 row with its MPS,
//   qe << 16 | nmps << 8 | nlps << 2 | switch << 1 | mps,
// so that a decision reads one shared word, and Table C.2 (these words
// with mps 0, in shared memory) is read only on a state transition.
__device__ __forceinline__ uint32_t ctx_row(int i) {
  const QeRow r = kTable[i];
  return (static_cast<uint32_t>(r.qe) << 16) | (r.nmps << 8) |
         (r.nlps << 2) | (r.sw << 1);
}

__device__ __forceinline__ uint32_t ctx_init(int cx) {
  const int p = cx < kNumCtxs ? kCtxInit[cx] : 0;
  return ctx_row(p >> 1) | (p & 1);
}

// The word after a renormalising decision: NLPS (and MPS ^ SWITCH) after
// an LPS, NMPS after an MPS. `rows` holds ctx_row(0 .. kStates - 1).
__device__ __forceinline__ uint32_t ctx_next(uint32_t cw, int lps,
                                             const uint32_t* rows) {
  const int idx = lps ? (cw >> 2) & 63 : (cw >> 8) & 63;
  return rows[idx] | ((cw & 1) ^ (lps & (cw >> 1)));
}

// (index << 1) | mps of a context word: the row whose (Qe, NMPS) it holds
// (unique in Table C.2).
__device__ __forceinline__ uint32_t ctx_state(uint32_t cw,
                                              const uint32_t* rows) {
  int i = 0;
  while (i < kStates - 1 && (rows[i] >> 8) != (cw >> 8)) ++i;
  return (static_cast<uint32_t>(i) << 1) | (cw & 1);
}

}  // namespace
