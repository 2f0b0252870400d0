// HT cleanup-pass encoder for a group of same-size code-blocks, for Hopper
// (sm_90a): coefficients in, finished cleanup segments out.
//
// Replaces the Pallas TPU kernels of grokimagecompression_tpu/ops/
// ht_scan_pallas.py, the VLC / MagSgn packer (_grid_scan_call, pallas_call
// at :175, reached through vlc_scan :282 and ms_scan :308) and the MEL
// coder (mel_scan, pallas_call at :257), together with everything around
// them: the op-stream build of ht_jax.py (_quad_stage :125, _context_stage
// :156, _vlc_uvlc_stage :204, _magsgn_ops :303; the port's
// ops/ht_torch.op_streams), the termination metrics (ht_jax._group_metrics,
// ht_torch.group_metrics), the word placement and the host's byte splice
// (ht_jax.assemble_segments_host, the port's ops/ht_tables.py). It writes
// what ops/ht_enc.encode_segments_plain assembles, byte for byte: the
// coders follow the reference's step bodies (ops/ht_scan.py mel_step,
// vlc_step, ms_step), whose byte streams depend only on the bits appended,
// not on how the appends were cut into steps.
//
// One code-block is one team of kTeam threads; a CTA holds kBlocks teams.
// What bounds it: the three streams are sequential codes over a block, so
// the kernel is bound by the latency of its longest chain, not by bytes (a
// 64x64 block reads 16 KB and writes a few KB) or by operations. The
// design keeps that chain short:
//   - the team loads its block's int32 coefficients into shared memory
//     with 16-byte cp.async copies (4-byte ones when the tensor is not
//     16-byte aligned), then computes every per-quad field in parallel,
//     nothing written to device memory between stages:
//       A. per quad: significance, exponents, rho, emax, eps, and each
//          sample's MagSgn value s = v - 2 + sign, written over the
//          coefficients quad-major with a pad word every 8 quads;
//       B+C. per quad pair, from the quad row above in shared memory: the
//          context c_q, kappa, U_q, u, the CxtVLC + UVLC codeword of the
//          pair and its length (the CxtVLC and UVLC tables read through
//          the read-only cache), the pair's three MEL events, and each
//          quad's four MagSgn lengths m_n;
//       D. each thread takes a run of consecutive quads and pairs; a scan
//          over the team gives each run's first bit in the unstuffed
//          MagSgn and VLC streams and the compacted stream of valid MEL
//          events, and the thread writes its run there (its inner words
//          with plain stores). The padded layouts put a warp's runs on 32
//          banks (without them, 64-wide blocks put them on 2);
//   - then the coders run side by side on shared memory: the MagSgn and
//     the VLC stuffer a warp each, cutting up to 128 bytes a step, four a
//     lane, and keeping those before the first byte whose width changes
//     (after 0xFF, MagSgn takes 7 bits; after a byte above 0x8F, VLC takes
//     7 when they are ones), and the MEL coder one thread, which takes a
//     run of 0 events at once up to its next hit. kWarpCoders = false puts
//     the three in one warp, a thread each, stuffing four bytes at a time
//     while no width changes (the trial that chip_smoke.py runs). Cutting
//     a concatenated stream gives the bytes of the reference's step bodies
//     (ops/ht_scan.py ms_step, vlc_step, mel_step), which depend only on
//     the bits appended, not on how the appends were cut into steps;
//   - the epilogue terminates the streams (MagSgn tail dropped or
//     appended, MEL pending run bit and tail, the MEL / VLC fuse rule of
//     group_metrics), and the team writes the segment (MagSgn, MEL, the
//     pending VLC byte unless fused, VLC reversed, scup in the last two
//     bytes) into the lane's region of the output with consecutive
//     threads on consecutive bytes. A second kernel packs the regions to
//     the segments' lengths, a CTA a lane.
//
// Lane regions: lane b writes from out[off[b]], and off (from the
// wrapper, ops/ht_enc.lane_bounds) gives each lane
//     floor((4 nq m + 48 np + 5) / 7) + 4 bytes,
// nq the quads, np the quad pairs of the block, m = min(Mb + 2, 32). Proof:
// every byte of the three streams carries at least 7 payload bits (MagSgn
// and MEL: 7 after 0xFF, else 8; VLC: 7 or 8 by the 0x8F / 0x7F rule).
// MagSgn appends m_n <= U_q <= min(Mb + 2, 32) bits a sample (exponents
// are at most Mb + 2 since v < 2^(Mb + 2), kappa at most the largest
// neighbour exponent - 1), so it emits at most floor(4 nq m / 7) bytes,
// plus one tail byte. MEL codes at most 3 events a pair of at most 1 + 5
// bits, plus the pending run bit: at most floor((18 np + 1) / 7) bytes
// with at least 7 bits (the extra byte included), plus the tail byte.
// VLC holds 4 initial bits and at most 7 + 7 + 16 bits a pair: at most
// floor((30 np + 4) / 7) bytes, plus the pending byte. Then the scup byte:
// the sum is at most the bound above. The shared-memory buffers are sized
// the same way (MagSgn with the launch's largest m, which every lane's Mb
// must respect). A lane that would pass its region or a buffer traps, so
// nothing is truncated silently.
//
// Plain C interface (bound with ctypes): the entry point launches on the
// given stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocks = 1;             // code-blocks a CTA
constexpr bool kWarpCoders = true;     // the three coders in three warps
constexpr int kTeam = 128;             // threads a code-block
constexpr int kEncWords = 2048;        // enc0 | enc1 << 16, then UVLC
constexpr int kMaxQuads = 1024 / kTeam;   // quads a thread in stage A

// Index i of an array with one pad word after every 32: a warp whose
// lanes take runs of 2 to 8 consecutive entries reads 32 banks.
__host__ __device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// MEL_EXP, four bits an entry: the exponent of MEL state k
constexpr uint64_t kMelExp = 0x5433222111000ull;

// The shape of one group and the layout of a team's shared memory.
struct Layout {
  int qh, qw, npr;       // quad rows, quads a row, quad pairs a row
  int nq, np;            // quads, quad pairs
  int ms_cap, mel_cap, vlc_cap;   // bytes of the three output buffers
  int words;             // 32-bit words of one team's region
  // word offsets inside a team's region: the samples at 0 (the
  // coefficients [2 qh][2 qw], then the MagSgn values quad-major, 4 q + n
  // + q / 8, then the MagSgn bytes when they fit there), the quad words,
  // the quads' MagSgn lengths, the pairs' codewords and lengths (these
  // three by pad32), the raw MagSgn and VLC bits and MEL events, the
  // scan, the epilogue's slots, the output bytes
  int o_qa, o_qm, o_vw, o_vm, o_rms, o_rvlc, o_rmel, o_scan, o_fin, o_ms,
      o_mel, o_vlc;
  int raw_words;         // of the three raw streams together

  __host__ __device__ void init(int qh_, int qw_, int m_max) {
    qh = qh_;
    qw = qw_;
    npr = (qw + 1) / 2;
    nq = qh * qw;
    np = qh * npr;
    ms_cap = (4 * nq * m_max) / 7 + 1;
    mel_cap = (18 * np + 1) / 7 + 1;
    vlc_cap = (30 * np + 4) / 7;
    o_qa = 4 * nq + nq / 8 + 1;
    o_qm = o_qa + nq;
    o_vw = o_qm + pad32(nq);
    o_vm = o_vw + pad32(np);
    o_rms = o_vm + pad32(np);
    o_rvlc = o_rms + (4 * nq * m_max + 31) / 32 + 3;
    o_rmel = o_rvlc + (30 * np + 4 + 31) / 32 + 3;
    o_scan = o_rmel + (3 * np + 31) / 32 + 3;
    raw_words = o_scan - o_rms;
    o_fin = o_scan + 16;
    const int end = (o_fin + 16 + 3) & ~3;
    o_ms = ms_cap + 1 <= 4 * o_qa ? 0 : end;
    o_mel = o_ms ? o_ms + words16(ms_cap + 1) : end;
    o_vlc = o_mel + words16(mel_cap + 1);
    words = o_vlc + words16(vlc_cap + 1);
  }
  // 32-bit words that hold n bytes, rounded up to 16 bytes
  __host__ __device__ static int words16(int n) { return (n + 15) / 16 * 4; }
};

// fin[] slots: what the coders leave for the epilogue
enum {
  kMsBits = 0,   // raw MagSgn bits
  kVlcBits,      // raw VLC bits, the 4 initial ones included
  kMelEvents,    // MEL events
  kMsN,          // MagSgn bytes, tail included, drop applied
  kMelN,         // MEL bytes emitted, the extra byte included
  kMelTmp,       // MEL tail byte before the fuse rule
  kMelMask,
  kVlcN,         // VLC bytes emitted
  kVtmp,
  kVused,
  kSegLen,       // the epilogue's results
  kScup,
  kVx,           // the pending VLC byte is written
  kMelTail,      // 1 + the MEL tail byte, 0 without one
};

__device__ __forceinline__ int bit_length(uint32_t x) {
  return x ? 32 - __clz(static_cast<int>(x)) : 0;
}

__device__ __forceinline__ uint32_t low_bits(uint32_t x, int n) {
  return n >= 32 ? x : x & ((1u << n) - 1u);
}

// Stage A for quad q: its samples' MagSgn values into sv, and the quad
// word rho | eps << 4 | emax << 8 | e1 << 14 | e3 << 20.
__device__ __forceinline__ void quad_stage(const uint32_t* s, uint32_t* qa,
                                           const Layout& L, int q,
                                           uint32_t mask, uint32_t* sv) {
  const int r = q / L.qw, c = q - r * L.qw;
  const int W = 2 * L.qw;
  const int i0 = 2 * r * W + 2 * c;
  const int idx[4] = {i0, i0 + W, i0 + 1, i0 + W + 1};
  int e[4];
  uint32_t rho = 0;
  for (int n = 0; n < 4; ++n) {
    const int32_t x = static_cast<int32_t>(s[idx[n]]);
    const uint32_t mag = x < 0 ? 0u - static_cast<uint32_t>(x)
                               : static_cast<uint32_t>(x);
    const uint32_t v = (mag & mask) << 1;
    e[n] = v ? bit_length(v - 1u) : 0;
    rho |= (v != 0u ? 1u : 0u) << n;
    sv[n] = v - 2u + (x < 0 ? 1u : 0u);
  }
  const int emax = max(max(e[0], e[1]), max(e[2], e[3]));
  uint32_t eps = 0;
  for (int n = 0; n < 4; ++n) eps |= (e[n] == emax ? 1u : 0u) << n;
  qa[q] = rho | eps << 4 | static_cast<uint32_t>(emax) << 8 |
          static_cast<uint32_t>(e[1]) << 14 | static_cast<uint32_t>(e[3]) << 20;
}

__device__ __forceinline__ int qa_rho(uint32_t w) { return w & 15; }
__device__ __forceinline__ int qa_eps(uint32_t w) { return (w >> 4) & 15; }
__device__ __forceinline__ int qa_emax(uint32_t w) { return (w >> 8) & 63; }
__device__ __forceinline__ int qa_e1(uint32_t w) { return (w >> 14) & 63; }
__device__ __forceinline__ int qa_e3(uint32_t w) { return (w >> 20) & 63; }

// Stage B for quad (r, c): the context and the CxtVLC table entry, as
// ht_torch._context_stage and the table lookup of _vlc_uvlc_stage.
struct QuadCtx {
  int cq, Uq, u, t;
};

__device__ __forceinline__ QuadCtx quad_ctx(const uint32_t* qa,
                                            const uint32_t* __restrict__ tbl,
                                            const Layout& L, int r, int c) {
  const uint32_t w = qa[r * L.qw + c];
  const int rho = qa_rho(w);
  const int rho_l = c > 0 ? qa_rho(qa[r * L.qw + c - 1]) : 0;
  int cq, kappa = 1;
  if (r == 0) {
    cq = (rho_l >> 1) | (rho_l & 1);
  } else {
    const uint32_t* p = qa + (r - 1) * L.qw;
    const uint32_t pc = p[c];
    const uint32_t pl = c > 0 ? p[c - 1] : 0u;
    const bool right = c + 1 < L.qw;
    const uint32_t pr = right ? p[c + 1] : 0u;
    // ev(c) = max(e3[c-1], e1[c]); ev(c+1) = max(e3[c], e1[c+1]) or e3[c]
    int max_e = max(max(qa_e3(pl), qa_e1(pc)),
                    max(qa_e3(pc), right ? qa_e1(pr) : 0)) - 1;
    const int cx0 = ((qa_rho(pc) >> 1) & 1) | ((qa_rho(pl) >> 3) & 1);
    const int cx1 = right ? ((qa_rho(pr) >> 1) & 1) | ((qa_rho(pc) >> 3) & 1)
                          : (qa_rho(pc) >> 3) & 1;
    cq = cx0 | (cx1 << 2);
    if (c > 0) cq |= ((rho_l >> 1) & 2) | ((rho_l >> 2) & 2);
    if (__popc(rho) >= 2) kappa = max(max_e, 1);
  }
  QuadCtx x;
  x.cq = cq;
  x.Uq = max(qa_emax(w), kappa);
  x.u = x.Uq - kappa;
  const int eps_used = x.u > 0 ? qa_eps(w) : 0;
  const uint32_t e = __ldg(tbl + ((cq << 8) | (rho << 4) | eps_used));
  x.t = static_cast<int>(r == 0 ? e & 0xFFFFu : e >> 16);
  return x;
}

// UVLC prefix | prefix length << 8 | suffix << 16 | suffix length << 24
__device__ __forceinline__ void uvlc(const uint32_t* __restrict__ tbl, int u,
                                     uint32_t& p, int& pl, uint32_t& sf,
                                     int& sl) {
  const uint32_t e = __ldg(tbl + kEncWords + u);
  p = e & 0xFF;
  pl = (e >> 8) & 0xFF;
  sf = (e >> 16) & 0xFF;
  sl = e >> 24;
}

// Stages B and C for quad pair p: the pair's codeword (vw) and its length
// with the MEL events (vm: length | valid << 8 | bits << 12), and the
// quads' MagSgn lengths and their sum (qm: m_0 | m_1 << 6 | m_2 << 12 |
// m_3 << 18 | sum << 24).
__device__ __forceinline__ void pair_stage(const uint32_t* qa, uint32_t* qm,
                                           uint32_t* vw, uint32_t* vm,
                                           const uint32_t* __restrict__ tbl,
                                           const Layout& L, int p) {
  const int r = p / L.npr, k = p - r * L.npr;
  const int c0 = 2 * k;
  const bool has_q1 = c0 + 1 < L.qw;
  const QuadCtx x0 = quad_ctx(qa, tbl, L, r, c0);
  QuadCtx x1{0, 0, 0, 0};
  if (has_q1) x1 = quad_ctx(qa, tbl, L, r, c0 + 1);
  const int rho0 = qa_rho(qa[r * L.qw + c0]);
  const int rho1 = has_q1 ? qa_rho(qa[r * L.qw + c0 + 1]) : 0;

  const int u0 = x0.u, u1 = x1.u;
  const uint32_t v0 = (x0.t >> 8) & 0xFF, v1 = (x1.t >> 8) & 0xFF;
  const int l0 = (x0.t >> 4) & 7, l1 = (x1.t >> 4) & 7;
  const bool init = r == 0;
  const bool both_gt2 = init && u0 > 2 && u1 > 2;
  const bool special = init && u0 > 2 && u1 > 0 && !both_gt2;
  uint32_t uw;
  int ul;
  {
    const int a0 = both_gt2 ? u0 - 2 : u0;
    const int a1 = both_gt2 ? u1 - 2 : u1;
    uint32_t p0, s0, p1, s1;
    int pl0, sl0, pl1, sl1;
    uvlc(tbl, a0, p0, pl0, s0, sl0);
    uvlc(tbl, a1, p1, pl1, s1, sl1);
    if (special) {
      uw = p0 | static_cast<uint32_t>(min(max(u1 - 1, 0), 1)) << pl0 |
           s0 << (pl0 + 1);
      ul = pl0 + 1 + sl0;
    } else {
      uw = p0 | p1 << pl0 | s0 << (pl0 + pl1) | s1 << (pl0 + pl1 + sl0);
      ul = pl0 + pl1 + sl0 + sl1;
    }
  }
  vw[pad32(p)] = v0 | v1 << l0 | uw << (l0 + l1);
  const uint32_t valid = (x0.cq == 0 ? 1u : 0u) |
                         (has_q1 && x1.cq == 0 ? 2u : 0u) |
                         (init && u0 > 0 && u1 > 0 ? 4u : 0u);
  const uint32_t bits = (rho0 ? 1u : 0u) | (rho1 ? 2u : 0u) |
                        (min(u0, u1) > 2 ? 4u : 0u);
  vm[pad32(p)] = static_cast<uint32_t>(l0 + l1 + ul) | valid << 8 |
                 bits << 12;

  for (int j = 0; j < (has_q1 ? 2 : 1); ++j) {
    const QuadCtx& x = j ? x1 : x0;
    const int rho = j ? rho1 : rho0;
    uint32_t m = 0, sum = 0;
    for (int n = 0; n < 4; ++n)
      if ((rho >> n) & 1) {
        const uint32_t mn = static_cast<uint32_t>(x.Uq - ((x.t >> n) & 1));
        m |= mn << (6 * n);
        sum += mn;
      }
    qm[pad32(r * L.qw + c0 + j)] = m | sum << 24;
  }
}

// The 32 bits of a raw stream from bit o (zeros past its end).
__device__ __forceinline__ uint32_t get32(const uint32_t* raw, int o) {
  const int w = o >> 5, sh = o & 31;
  const uint64_t x = raw[w] | static_cast<uint64_t>(raw[w + 1]) << 32;
  return static_cast<uint32_t>(x >> sh);
}

// Writes one thread's run of a raw stream from bit o: the words inside
// the run with plain stores, its first and last words (which the
// neighbouring runs share) with atomicOr.
struct BitWriter {
  uint32_t* raw;
  uint64_t acc;
  int nacc, w;
  bool first;

  __device__ __forceinline__ BitWriter(uint32_t* r, int o)
      : raw(r), acc(0), nacc(o & 31), w(o >> 5), first(true) {}
  // the low n <= 32 bits of v, v < 2^n
  __device__ __forceinline__ void put(uint32_t v, int n) {
    acc |= static_cast<uint64_t>(v) << nacc;
    nacc += n;
    if (nacc >= 32) {
      if (first)
        atomicOr(raw + w, static_cast<uint32_t>(acc));
      else
        raw[w] = static_cast<uint32_t>(acc);
      first = false;
      ++w;
      acc >>= 32;
      nacc -= 32;
    }
  }
  __device__ __forceinline__ void close() {
    if (nacc > 0) atomicOr(raw + w, static_cast<uint32_t>(acc));
  }
};

// Inclusive sum over a warp.
__device__ __forceinline__ int warp_sum(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Stage D: each thread takes a run of quads and a run of pairs; a scan
// over the team (in each warp by shuffles, then across the warps' sums)
// gives each run's first bit, and the thread writes its samples' MagSgn
// bits, its pairs' codewords and its pairs' MEL event bits (valid events
// only) into the raw streams. fin[] gets the streams' lengths.
__device__ void pack_stage(const uint32_t* s, const uint32_t* qm,
                           const uint32_t* vw, const uint32_t* vm,
                           uint32_t* rms, uint32_t* rvlc, uint32_t* rmel,
                           int32_t* scan, int32_t* fin, const Layout& L,
                           int tid, bool live) {
  const int qn = (L.nq + kTeam - 1) / kTeam, pn = (L.np + kTeam - 1) / kTeam;
  const int q0 = min(tid * qn, L.nq), q1 = min(q0 + qn, L.nq);
  const int p0 = min(tid * pn, L.np), p1 = min(p0 + pn, L.np);
  int sums[3] = {0, 0, 0};      // MagSgn bits, VLC bits, MEL events
  if (live) {
    for (int q = q0; q < q1; ++q) sums[0] += qm[pad32(q)] >> 24;
    for (int p = p0; p < p1; ++p) {
      const uint32_t v = vm[pad32(p)];
      sums[1] += v & 63;
      sums[2] += __popc((v >> 8) & 7);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
  int incl[3];
  for (int i = 0; i < 3; ++i) {
    incl[i] = warp_sum(sums[i], lane);
    if (lane == 31) scan[4 * i + warp] = incl[i];
  }
  __syncthreads();
  int first[3], total[3];
  for (int i = 0; i < 3; ++i) {
    first[i] = incl[i] - sums[i];
    total[i] = 0;
    for (int k = 0; k < kTeam / 32; ++k) {
      if (k < warp) first[i] += scan[4 * i + k];
      total[i] += scan[4 * i + k];
    }
  }
  if (!live) return;
  {
    BitWriter bw(rms, first[0]);
    for (int q = q0; q < q1; ++q) {
      const uint32_t m = qm[pad32(q)];
      if ((m >> 24) == 0u) continue;
      const uint32_t* sq = s + 4 * q + (q >> 3);
      for (int n = 0; n < 4; ++n) {
        const int mn = (m >> (6 * n)) & 63;
        bw.put(low_bits(sq[n], mn), mn);
      }
    }
    bw.close();
  }
  {
    BitWriter bv(rvlc, 4 + first[1]);    // behind the 4 initial one bits
    BitWriter be(rmel, first[2]);
    for (int p = p0; p < p1; ++p) {
      const uint32_t v = vm[pad32(p)];
      const int l = v & 63;
      bv.put(low_bits(vw[pad32(p)], l), l);
      for (int j = 0; j < 3; ++j)
        if ((v >> (8 + j)) & 1) be.put((v >> (12 + j)) & 1, 1);
    }
    bv.close();
    be.close();
  }
  if (tid == 0) {
    atomicOr(rvlc, 0xFu);
    fin[kMsBits] = total[0];
    fin[kVlcBits] = 4 + total[1];
    fin[kMelEvents] = total[2];
  }
}

// A reader of a raw stream: a 64-bit window of its next bits, refilled a
// word at a time.
struct RawBits {
  const uint32_t* raw;
  uint64_t win;
  int nb, wi, rem;      // bits in the window, next word, bits left

  __device__ __forceinline__ void init(const uint32_t* r, int bits) {
    raw = r;
    win = r[0] | static_cast<uint64_t>(r[1]) << 32;
    nb = 64;
    wi = 2;
    rem = bits;
  }
  __device__ __forceinline__ void refill() {
    if (nb < 32) {
      win |= static_cast<uint64_t>(raw[wi++]) << nb;
      nb += 32;
    }
  }
  __device__ __forceinline__ void take(int n) {
    win >>= n;
    nb -= n;
    rem -= n;
  }
};

__device__ __forceinline__ void put4(uint8_t* buf, int n, int cap,
                                     uint32_t x) {
  for (int i = 0; i < 4; ++i)
    if (n + i < cap) buf[n + i] = static_cast<uint8_t>(x >> (8 * i));
}

// MsEnc::terminate on the bits left (rem < maxb, value x): append the
// padded tail, or drop a trailing 0xFF. Returns the stream's bytes.
__device__ __forceinline__ int ms_terminate(uint8_t* buf, int n, int cap,
                                            uint32_t x, int rem, int maxb) {
  const uint32_t tail =
      (low_bits(x, rem) | (0xFFu << rem)) & ((1u << maxb) - 1u);
  if (rem > 0 && tail != 0xFFu) {
    if (n < cap) buf[n] = static_cast<uint8_t>(tail);
    ++n;
  } else if (rem == 0 && maxb == 7) {
    --n;
  }
  if (n > cap) __trap();
  return n;
}

// The MagSgn stuffer (ms_step's byte stream), one thread: bytes of 8
// bits, 7 after 0xFF, four at a time while none of the first three is
// 0xFF.
__device__ void ms_coder(const uint32_t* rms, uint8_t* buf, int32_t* fin,
                         const Layout& L) {
  RawBits r;
  r.init(rms, fin[kMsBits]);
  int maxb = 8, n = 0;
  while (r.rem >= maxb) {
    r.refill();
    const uint32_t x = static_cast<uint32_t>(r.win);
    if (maxb == 8 && r.rem >= 32 &&
        (__vcmpeq4(x, 0xFFFFFFFFu) & 0x00FFFFFFu) == 0u) {
      put4(buf, n, L.ms_cap, x);
      n += 4;
      r.take(32);
      maxb = (x >> 24) == 0xFFu ? 7 : 8;
      continue;
    }
    const uint32_t byte = x & ((1u << maxb) - 1u);
    if (n < L.ms_cap) buf[n] = static_cast<uint8_t>(byte);
    ++n;
    r.take(maxb);
    maxb = byte == 0xFFu ? 7 : 8;
  }
  r.refill();
  fin[kMsN] = ms_terminate(buf, n, L.ms_cap, static_cast<uint32_t>(r.win),
                           r.rem, maxb);
}

// Bytes 4 l .. 4 l + 3 of a warp stuffer's step, for lane l: byte 0 of
// lane 0 takes w0 bits from bit pos, every other byte 8. ncomp: the
// complete bytes, n7: the bytes with at least 7 bits in the stream.
struct Lane4 {
  uint32_t x;
  int ncomp, n7;

  __device__ __forceinline__ Lane4(const uint32_t* raw, int T, int pos,
                                   int w0, int lane) {
    // where byte 0 would start if it had 8 bits
    const int b0 = lane == 0 ? pos + w0 - 8 : pos + w0 + 24 + 32 * (lane - 1);
    x = lane == 0 ? (get32(raw, pos) & ((1u << w0) - 1u)) |
                        get32(raw, min(pos + w0, T)) << 8
                  : get32(raw, min(b0, T));
    ncomp = min(max(T - b0, 0) >> 3, 4);
    n7 = min(max(T - b0 + 1, 0) >> 3, 4);
  }
};

// The bytes below k of a word, as a byte mask.
__device__ __forceinline__ uint32_t low_bytes(int k) {
  return k >= 4 ? 0xFFFFFFFFu : (1u << (8 * k)) - 1u;
}

// A warp stuffer's step writes bytes [0, cnt) of the step from buf[n].
__device__ __forceinline__ void put_step(uint8_t* buf, int n, int cap,
                                         uint32_t x, int lane, int cnt) {
  for (int k = 0; k < 4; ++k) {
    const int i = 4 * lane + k;
    if (i < cnt && n + i < cap) buf[n + i] = static_cast<uint8_t>(x >> (8 * k));
  }
}

// The MagSgn stuffer, one warp: a step cuts up to 128 bytes, four a lane
// (the first with the step's width, 7 after 0xFF, else 8; the others with
// 8), and keeps those up to the first 0xFF (the width after it changes)
// or the first incomplete one.
__device__ void ms_coder_warp(const uint32_t* rms, uint8_t* buf,
                              int32_t* fin, const Layout& L, int lane) {
  const int T = fin[kMsBits];
  int pos = 0, maxb = 8, n = 0;
  while (true) {
    const Lane4 b(rms, T, pos, maxb, lane);
    const uint32_t ff = __vcmpeq4(b.x, 0xFFFFFFFFu) & low_bytes(b.ncomp);
    const int j = ff ? (__ffs(ff) - 1) >> 3 : b.ncomp;
    const unsigned stop = __ballot_sync(0xFFFFFFFFu, j < 4);
    const int f = stop ? __ffs(stop) - 1 : 32;
    const int jf = __shfl_sync(0xFFFFFFFFu, j, f & 31);
    const bool at_ff =
        __shfl_sync(0xFFFFFFFFu, ff != 0u ? 1 : 0, f & 31) && f < 32;
    const int cnt = f < 32 ? 4 * f + jf + (at_ff ? 1 : 0) : 128;
    put_step(buf, n, L.ms_cap, b.x, lane, cnt);
    n += cnt;
    if (cnt > 0) {
      pos += maxb + 8 * (cnt - 1);
      maxb = at_ff ? 7 : 8;
    }
    if (f < 32 && !at_ff) break;
  }
  if (lane == 0)
    fin[kMsN] = ms_terminate(buf, n, L.ms_cap, get32(rms, pos), T - pos,
                             maxb);
}

// The VLC stuffer (vlc_step's byte stream), one thread: a byte takes 8
// bits, or 7 (0x7F) after a byte above 0x8F when its 7 bits are all
// ones; the stream starts as if after such a byte.
__device__ void vlc_coder(const uint32_t* rvlc, uint8_t* buf, int32_t* fin,
                          const Layout& L) {
  RawBits r;
  r.init(rvlc, fin[kVlcBits]);
  bool lg8f = true;
  int n = 0;
  while (true) {
    r.refill();
    const uint32_t x = static_cast<uint32_t>(r.win);
    if (!lg8f && r.rem >= 32) {
      // bytes above 0x8F, and bytes whose low 7 bits are all ones: four
      // plain bytes unless one of the first follows one of the second
      const uint32_t gt = __vcmpgtu4(x, 0x8F8F8F8Fu);
      const uint32_t s7 = __vcmpeq4(x | 0x80808080u, 0xFFFFFFFFu);
      if (((gt << 8) & s7) == 0u) {
        put4(buf, n, L.vlc_cap, x);
        n += 4;
        r.take(32);
        lg8f = (x >> 24) > 0x8Fu;
        continue;
      }
    }
    if (lg8f) {
      if (r.rem < 7) break;
      if ((x & 0x7Fu) == 0x7Fu) {
        if (n < L.vlc_cap) buf[n] = 0x7F;
        ++n;
        r.take(7);
        lg8f = false;
        continue;
      }
    }
    if (r.rem < 8) break;
    const uint32_t byte = x & 0xFFu;
    if (n < L.vlc_cap) buf[n] = static_cast<uint8_t>(byte);
    ++n;
    r.take(8);
    lg8f = byte > 0x8Fu;
  }
  if (n > L.vlc_cap) __trap();
  fin[kVlcN] = n;
  fin[kVtmp] = static_cast<int32_t>(low_bits(static_cast<uint32_t>(r.win),
                                             r.rem));
  fin[kVused] = r.rem;
}

// The VLC stuffer, one warp: a step cuts up to 128 bytes, four a lane
// (the first with 7 bits when it follows a byte above 0x8F and its 7 bits
// are ones, the others with 8), and keeps those before the first byte
// that would be such a 7-bit one, or the first incomplete one.
__device__ void vlc_coder_warp(const uint32_t* rvlc, uint8_t* buf,
                               int32_t* fin, const Layout& L, int lane) {
  const int T = fin[kVlcBits];
  int pos = 0, n = 0;
  bool lg8f = true;
  while (true) {
    const int w0 =
        lg8f && pos + 7 <= T && (get32(rvlc, pos) & 0x7Fu) == 0x7Fu ? 7 : 8;
    const Lane4 b(rvlc, T, pos, w0, lane);
    const uint32_t gt = __vcmpgtu4(b.x, 0x8F8F8F8Fu) & low_bytes(b.ncomp);
    const int p3 = __shfl_up_sync(0xFFFFFFFFu, static_cast<int>(gt >> 31), 1);
    const uint32_t prev = gt << 8 | (lane > 0 && p3 ? 0xFFu : 0u);
    const uint32_t seven =
        prev & __vcmpeq4(b.x | 0x80808080u, 0xFFFFFFFFu) & low_bytes(b.n7);
    const int ks = seven ? (__ffs(seven) - 1) >> 3 : 4;
    const bool st = ks < 4 && ks <= b.ncomp;      // a 7-bit byte at ks
    const int j = st ? ks : b.ncomp;
    const unsigned stop = __ballot_sync(0xFFFFFFFFu, j < 4);
    const int f = stop ? __ffs(stop) - 1 : 32;
    const int jf = __shfl_sync(0xFFFFFFFFu, j, f & 31);
    const bool at_seven =
        __shfl_sync(0xFFFFFFFFu, st ? 1 : 0, f & 31) && f < 32;
    const int cnt = f < 32 ? 4 * f + jf : 128;
    put_step(buf, n, L.vlc_cap, b.x, lane, cnt);
    n += cnt;
    if (cnt > 0) {
      pos += w0 + 8 * (cnt - 1);
      const int c = cnt - 1;
      lg8f = (__shfl_sync(0xFFFFFFFFu, gt, c >> 2) >> (8 * (c & 3))) & 1u;
    }
    if (f < 32 && !at_seven) break;
  }
  if (lane == 0) {
    if (n > L.vlc_cap) __trap();
    fin[kVlcN] = n;
    fin[kVtmp] = static_cast<int32_t>(low_bits(get32(rvlc, pos), T - pos));
    fin[kVused] = T - pos;
  }
}

// Append cnt <= 6 MEL bits (value v) to the byte accumulator (mel_step's
// packing: bytes of 8 bits, 7 after 0xFF).
struct MelBits {
  int tmp = 0, nbits = 0, cap = 8, n = 0;
  __device__ __forceinline__ void put(int v, int cnt, uint8_t* buf,
                                      int bcap) {
    const int combined = (tmp << cnt) | v;
    const int nb = nbits + cnt;
    if (nb >= cap) {
      const int rem = nb - cap;
      const int byte = combined >> rem;
      if (n < bcap) buf[n] = static_cast<uint8_t>(byte);
      ++n;
      tmp = combined & ((1 << rem) - 1);
      nbits = rem;
      cap = byte == 0xFF ? 7 : 8;
    } else {
      tmp = combined;
      nbits = nb;
    }
  }
};

// The MEL coder (mel_step's byte stream) over the valid events, and its
// tail (group_metrics: the pending run bit, the extra byte). A run of
// 0 events is taken at once up to the next hit (the run reaching 2^e) or
// the next 1 event.
__device__ void mel_coder(const uint32_t* rmel, uint8_t* buf, int32_t* fin,
                          const Layout& L) {
  RawBits r;
  r.init(rmel, fin[kMelEvents]);
  MelBits m;
  int run = 0, k = 0;
  while (r.rem > 0) {
    r.refill();
    const uint32_t x = static_cast<uint32_t>(r.win);
    const int avail = min(r.rem, 32);
    const int z = x ? min(__ffs(x) - 1, avail) : avail;   // 0 events
    const int e = static_cast<int>(kMelExp >> (4 * k)) & 15;
    const int need = (1 << e) - run;
    if (z >= need) {            // a hit: '1', run 0, k up
      m.put(1, 1, buf, L.mel_cap);
      r.take(need);
      run = 0;
      k = min(k + 1, 12);
    } else if (z > 0) {
      run += z;
      r.take(z);
    } else {                    // a 1 event: '0' and the run's e bits
      m.put(run & ((1 << e) - 1), 1 + e, buf, L.mel_cap);
      r.take(1);
      run = 0;
      k = max(k - 1, 0);
    }
  }
  // the pending run bit, and the extra byte it may complete
  if (run > 0) m.put(1, 1, buf, L.mel_cap);
  if (m.n >= L.mel_cap) __trap();   // and the tail byte still fits
  const int remaining = m.cap - m.nbits;
  fin[kMelN] = m.n;
  fin[kMelTmp] = (m.tmp << remaining) & 0xFF;
  fin[kMelMask] = (0xFF << remaining) & 0xFF;
}

// The fuse rule and the segment's layout (group_metrics and
// assemble_segments_host); traps where the host splice would fail.
__device__ void finish(int32_t* fin, int region) {
  const int mel_tmp = fin[kMelTmp], mel_mask = fin[kMelMask];
  const int vtmp = fin[kVtmp], vused = fin[kVused], vlc_n = fin[kVlcN];
  const int vlc_mask = vused > 0 ? 0xFF >> (8 - vused) : 0;
  const bool nonzero = (mel_mask | vlc_mask) != 0;
  const int fuse = mel_tmp | vtmp;
  const bool fuse_ok = nonzero &&
                       ((((fuse ^ mel_tmp) & mel_mask) |
                         ((fuse ^ vtmp) & vlc_mask)) == 0) &&
                       fuse != 0xFF && vlc_n + 1 > 1;
  const int mel_n = fin[kMelN] + (nonzero ? 1 : 0);
  const int vx = nonzero && !fuse_ok ? 1 : 0;
  const int scup = mel_n + 1 + vlc_n + vx;
  const int len = fin[kMsN] + mel_n + vx + vlc_n + 1;
  if (len < 2 || scup >= 4096 || len > region) __trap();
  fin[kMelTail] = nonzero ? 1 + (fuse_ok ? fuse : mel_tmp) : 0;
  fin[kVx] = vx;
  fin[kScup] = scup;
  fin[kSegLen] = len;
}

// The finished segment's layout, read once from fin[].
struct Seg {
  int len, scup, ms_n, mel_e, mel_n, vx, vlc_n;
  uint32_t mel_tail, vtmp;

  __device__ __forceinline__ explicit Seg(const int32_t* fin)
      : len(fin[kSegLen]), scup(fin[kScup]), ms_n(fin[kMsN]),
        mel_e(fin[kMelN]), mel_n(fin[kMelN] + (fin[kMelTail] ? 1 : 0)),
        vx(fin[kVx]), vlc_n(fin[kVlcN]),
        mel_tail(static_cast<uint32_t>(fin[kMelTail] - 1)),
        vtmp(static_cast<uint32_t>(fin[kVtmp])) {}

  // byte i: MagSgn, MEL (+ tail), the pending VLC byte, VLC reversed,
  // scup in the low nibble of the second last byte and the last byte
  __device__ __forceinline__ uint32_t at(const uint8_t* ms, const uint8_t* mel,
                                         const uint8_t* vlc, int i) const {
    if (i == len - 1) return static_cast<uint32_t>(scup >> 4);
    uint32_t b;
    int j = i;
    if (j < ms_n) {
      b = ms[j];
    } else if ((j -= ms_n) < mel_n) {
      b = j < mel_e ? mel[j] : mel_tail;
    } else if ((j -= mel_n) < vx) {
      b = vtmp;
    } else {
      b = vlc[vlc_n - 1 - (j - vx)];
    }
    if (i == len - 2) b = (b & 0xF0u) | (static_cast<uint32_t>(scup) & 0xFu);
    return b;
  }
};

__global__ void __launch_bounds__(kBlocks * kTeam)
ht_enc_kernel(const int32_t* __restrict__ coeffs,
              const int32_t* __restrict__ mbs,
              const uint32_t* __restrict__ tbl,
              const int64_t* __restrict__ off, uint8_t* __restrict__ out,
              int32_t* __restrict__ lens, int B, int qh, int qw, int m_max) {
  extern __shared__ __align__(16) uint32_t smem_raw[];
  Layout L;
  L.init(qh, qw, m_max);
  const int team = threadIdx.x / kTeam, tid = threadIdx.x % kTeam;
  uint32_t* base = smem_raw + team * L.words;
  uint32_t* s = base;
  uint32_t* qa = base + L.o_qa;
  uint32_t* qm = base + L.o_qm;
  uint32_t* vw = base + L.o_vw;
  uint32_t* vm = base + L.o_vm;
  uint32_t* rms = base + L.o_rms;
  uint32_t* rvlc = base + L.o_rvlc;
  uint32_t* rmel = base + L.o_rmel;
  int32_t* scan = reinterpret_cast<int32_t*>(base + L.o_scan);
  int32_t* fin = reinterpret_cast<int32_t*>(base + L.o_fin);
  uint8_t* ms_buf = reinterpret_cast<uint8_t*>(base + L.o_ms);
  uint8_t* mel_buf = reinterpret_cast<uint8_t*>(base + L.o_mel);
  uint8_t* vlc_buf = reinterpret_cast<uint8_t*>(base + L.o_vlc);

  const int b = blockIdx.x * kBlocks + team;
  const bool live = b < B;
  const int nsamp = 4 * L.nq;
  const int mb = live ? mbs[b] : 0;
  if (live) {
    // a lane above the launch's largest Mb would pass its buffers
    if (mb < 0 || min(mb + 2, 32) > m_max) __trap();
    const int32_t* src = coeffs + static_cast<size_t>(b) * nsamp;
    if ((reinterpret_cast<uintptr_t>(coeffs) & 15) == 0) {
      for (int i = tid; i < nsamp / 4; i += kTeam)
        __pipeline_memcpy_async(s + 4 * i, src + 4 * i, 16);
    } else {
      for (int i = tid; i < nsamp; i += kTeam)
        __pipeline_memcpy_async(s + i, src + i, 4);
    }
    __pipeline_commit();
    for (int i = tid; i < L.raw_words; i += kTeam) rms[i] = 0;
  }
  const uint32_t mask = mb >= 31 ? 0xFFFFFFFFu : (2u << mb) - 1u;
  if (live) __pipeline_wait_prior(0);
  __syncthreads();

  // stage A reads the coefficients, then (after the barrier) writes the
  // MagSgn values over them, quad-major: the pack stage's runs of quads
  // read them without bank conflicts
  uint32_t sv[kMaxQuads][4];
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int q = tid + j * kTeam;
    if (live && q < L.nq) quad_stage(s, qa, L, q, mask, sv[j]);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxQuads; ++j) {
    const int q = tid + j * kTeam;
    if (live && q < L.nq)
      for (int n = 0; n < 4; ++n) s[4 * q + (q >> 3) + n] = sv[j][n];
  }
  if (live)
    for (int p = tid; p < L.np; p += kTeam)
      pair_stage(qa, qm, vw, vm, tbl, L, p);
  __syncthreads();
  pack_stage(s, qm, vw, vm, rms, rvlc, rmel, scan, fin, L, tid, live);
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  if (live) {
    if (kWarpCoders) {          // MagSgn and VLC a warp each, MEL a thread
      if (warp == 0)
        ms_coder_warp(rms, ms_buf, fin, L, lane);
      else if (warp == 1)
        vlc_coder_warp(rvlc, vlc_buf, fin, L, lane);
      else if (warp == 2 && lane == 0)
        mel_coder(rmel, mel_buf, fin, L);
    } else if (tid == 0) {      // a thread each, in one warp
      ms_coder(rms, ms_buf, fin, L);
    } else if (tid == 1) {
      vlc_coder(rvlc, vlc_buf, fin, L);
    } else if (tid == 2) {
      mel_coder(rmel, mel_buf, fin, L);
    }
  }
  __syncthreads();
  if (live && tid == 0)
    finish(fin, static_cast<int>(off[b + 1] - off[b]));
  __syncthreads();
  if (!live) return;
  const Seg seg(fin);
  uint8_t* dst = out + off[b];
  for (int i = tid; i < seg.len; i += kTeam)
    dst[i] = static_cast<uint8_t>(seg.at(ms_buf, mel_buf, vlc_buf, i));
  if (tid == 0) lens[b] = seg.len;
}

// Packs the lanes' segments: lane b's lens[b] bytes from src[off[b]] to
// dst[ends[b] - lens[b]], a CTA a lane, consecutive threads on
// consecutive bytes.
__global__ void __launch_bounds__(kTeam)
ht_pack_kernel(const uint8_t* __restrict__ src,
               const int64_t* __restrict__ off,
               const int32_t* __restrict__ lens,
               const int64_t* __restrict__ ends, uint8_t* __restrict__ dst) {
  const int b = blockIdx.x;
  const int n = lens[b];
  const uint8_t* from = src + off[b];
  uint8_t* to = dst + (ends[b] - n);
  for (int i = threadIdx.x; i < n; i += kTeam) to[i] = from[i];
}

}  // namespace

extern "C" {

// coeffs: (B, 2 qh, 2 qw) int32 code-blocks; mbs: (B,) int32, 0 <= Mb
// (from 31 up every magnitude bit is read) and min(Mb + 2, 32) <= m_max;
// tbl: (2081,) int32 (ht_tables.tables_on's "enc_packed": enc0 | enc1 <<
// 16, then the UVLC table); off: (B + 1,) int64 lane regions, each at
// least the bound above; out: the regions' bytes; lens: (B,) int32
// segment lengths. 4 qh qw <= 4096, 1 <= m_max <= 32.
int ht_enc_group(const void* coeffs, const void* mbs, const void* tbl,
                 const void* off, void* out, void* lens, int B, int qh,
                 int qw, int m_max, void* stream) {
  Layout L;
  L.init(qh, qw, m_max);
  const size_t smem = static_cast<size_t>(kBlocks) * L.words * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ht_enc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ht_enc_kernel<<<(B + kBlocks - 1) / kBlocks, kBlocks * kTeam, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs), static_cast<const int32_t*>(mbs),
      static_cast<const uint32_t*>(tbl), static_cast<const int64_t*>(off),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(lens), B, qh, qw,
      m_max);
  return static_cast<int>(cudaGetLastError());
}

// src, off, lens: ht_enc_group's outputs for B lanes; ends: (B,) int64
// cumulative lens; dst: (ends[B - 1],) uint8.
int ht_enc_pack(const void* src, const void* off, const void* lens,
                const void* ends, void* dst, int B, void* stream) {
  ht_pack_kernel<<<B, kTeam, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int64_t*>(off),
      static_cast<const int32_t*>(lens), static_cast<const int64_t*>(ends),
      static_cast<uint8_t*>(dst));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
