// Multi-level 2-D discrete wavelet transform (5/3 on int32, 9/7 on float32)
// for Hopper (sm_90a): one launch per level and axis.
//
// Replaces the Pallas TPU kernels _fused_whole and _fused_striped of
// grokimagecompression_tpu/ops/dwt_pallas.py (pallas_call at :254 and
// :307, reached through fwd_dwt_2d / inv_dwt_2d). It computes what the
// numpy oracle ops/dwt_np.py and the port's ops/dwt_torch.py compute, bit
// for bit: every level deinterleaves into low and high halves, with its
// own canvas parity and symmetric extension at both ends, and the 9/7
// steps are float32 operations in dwt_np's order, (l + r) first, then the
// product, then the add, each rounded on its own (__fadd_rn / __fmul_rn,
// which nvcc never contracts into an FMA; this file is also built with
// --fmad=false). The 9/7 constants come in from the wrapper as the
// float32 values dwt_torch uses.
//
// Left out of the TPU formulation: the in-place masked lifting at stride
// 2^level with iota masks and concatenated shifts, the halo striping and
// the VMEM budget. They exist for the TPU's vector unit and its fast
// memory; here each level's region is a plain strided array.
//
// Layout. A level's region is (N, h, w). The forward transform runs the
// vertical pass, then the horizontal one (dwt_np's order); its output
// buffer holds, per row block, low rows first, then high rows, and per
// row low columns first, then high columns: the four bands are views of
// it, and its top-left block is the next level's input. The inverse runs
// the horizontal pass (band rows into interleaved rows), then the
// vertical one.
//
// What bounds it: bytes. A 9/7 level costs about 14 float operations a
// sample against 8 bytes moved at least, far below the card's ratio of
// operations to bytes. The design:
//   - horizontal pass: one CTA per row; the row is loaded into shared
//     memory deinterleaved, each lifting step is a loop over the half it
//     updates, split across the CTA's threads, with __syncthreads()
//     between steps; the result is written back in one coalesced pass.
//     A row wider than kSmemFloats works the same way in a global scratch
//     row the wrapper allocates;
//   - vertical pass: one thread per column, neighbouring threads on
//     neighbouring columns so every access coalesces; each thread runs
//     the lifting steps down its column in place in the output buffer.
//     Columns are independent, so the steps need no barrier.
// Simple first: the vertical steps re-read the column from L2 once per
// lifting step; each thread keeps 8 of its updates' loads in flight.
//
// Plain C interface (bound with ctypes): every entry point launches on
// the given stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kColThreads = 128;
constexpr int kSmemFloats = 12288;  // 48 KB: rows up to this width in smem

struct K97 {
  float alpha, beta, gamma, delta, inv_k, k_half, two_over_k, k;
};

// A line of a level: low samples at lo[i * s] (i < ne), high samples at
// hi[j * s] (j < no); p is the canvas parity of the line's first sample.
template <typename T>
struct Line {
  T* lo;
  T* hi;
  int64_t s;
  int ne, no, p;
};

// Each lifting step updates one half of a line from the other half, so
// its updates are independent of each other. A thread takes its indices
// kBatch at a time and issues all their loads before any store: the loads
// of a batch are in flight together (the compiler may not move a load
// above an earlier store to the same buffer).
constexpr int kBatch = 8;

// hi[j] = f(hi[j], its two even neighbours) for j = j0, j0 + dj, ...
// (dwt_torch._odd_nbrs: left max(j - p, 0), right min(j + 1 - p, ne - 1))
template <typename T, class F>
__device__ __forceinline__ void predict(const Line<T>& L, int j0, int dj,
                                        F f) {
  for (int jb = j0; jb < L.no; jb += kBatch * dj) {
    T x[kBatch], l[kBatch], r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = jb + u * dj;
      if (j < L.no) {
        x[u] = L.hi[j * L.s];
        l[u] = L.lo[max(j - L.p, 0) * L.s];
        r[u] = L.lo[min(j + 1 - L.p, L.ne - 1) * L.s];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = jb + u * dj;
      if (j < L.no) L.hi[j * L.s] = f(x[u], l[u], r[u]);
    }
  }
}

// lo[i] = f(lo[i], its two odd neighbours) (dwt_torch._even_nbrs: left
// max(i - 1 + p, 0), right min(i + p, no - 1))
template <typename T, class F>
__device__ __forceinline__ void update(const Line<T>& L, int i0, int di,
                                       F f) {
  for (int ib = i0; ib < L.ne; ib += kBatch * di) {
    T x[kBatch], l[kBatch], r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = ib + u * di;
      if (i < L.ne) {
        x[u] = L.lo[i * L.s];
        l[u] = L.hi[max(i - 1 + L.p, 0) * L.s];
        r[u] = L.hi[min(i + L.p, L.no - 1) * L.s];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = ib + u * di;
      if (i < L.ne) L.lo[i * L.s] = f(x[u], l[u], r[u]);
    }
  }
}

// v[k] = f(v[k]) for k = k0, k0 + dk, ... < n (stride s), batched likewise
template <typename T, class F>
__device__ __forceinline__ void scale_half(T* v, int64_t s, int n, int k0,
                                           int dk, F f) {
  for (int kb = k0; kb < n; kb += kBatch * dk) {
    T x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (kb + u * dk < n) x[u] = v[(kb + u * dk) * s];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (kb + u * dk < n) v[(kb + u * dk) * s] = f(x[u]);
  }
}

template <typename T, class F>
__device__ __forceinline__ void scale(const Line<T>& L, int t0, int dt, F flo,
                                      F fhi) {
  scale_half(L.lo, L.s, L.ne, t0, dt, flo);
  scale_half(L.hi, L.s, L.no, t0, dt, fhi);
}

struct NoSync {
  __device__ void operator()() const {}
};
struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};

// 9/7 arithmetic, each operation rounded on its own
struct Add97 {
  float c;
  __device__ float operator()(float x, float l, float r) const {
    return __fadd_rn(x, __fmul_rn(c, __fadd_rn(l, r)));
  }
};
struct Sub97 {
  float c;
  __device__ float operator()(float x, float l, float r) const {
    return __fsub_rn(x, __fmul_rn(c, __fadd_rn(l, r)));
  }
};
struct Mul97 {
  float c;
  __device__ float operator()(float x) const { return __fmul_rn(x, c); }
};

// 5/3 arithmetic: arithmetic shifts of int32, as dwt_np
struct Fwd53P {
  __device__ int32_t operator()(int32_t x, int32_t l, int32_t r) const {
    return x - ((l + r) >> 1);
  }
};
struct Fwd53U {
  __device__ int32_t operator()(int32_t x, int32_t l, int32_t r) const {
    return x + ((l + r + 2) >> 2);
  }
};
struct Inv53U {
  __device__ int32_t operator()(int32_t x, int32_t l, int32_t r) const {
    return x - ((l + r + 2) >> 2);
  }
};
struct Inv53P {
  __device__ int32_t operator()(int32_t x, int32_t l, int32_t r) const {
    return x + ((l + r) >> 1);
  }
};

// The lifting of one line of n >= 2 samples, forward or inverse, its
// steps spread over threads t0, t0 + dt, ... and separated by `sync`.
template <class Sync>
__device__ void lift_fwd(const Line<float>& L, const K97& k, int t0, int dt,
                         Sync sync) {
  predict(L, t0, dt, Add97{k.alpha});
  sync();
  update(L, t0, dt, Add97{k.beta});
  sync();
  predict(L, t0, dt, Add97{k.gamma});
  sync();
  update(L, t0, dt, Add97{k.delta});
  sync();
  scale(L, t0, dt, Mul97{k.inv_k}, Mul97{k.k_half});
}

template <class Sync>
__device__ void lift_fwd(const Line<int32_t>& L, const K97&, int t0, int dt,
                         Sync sync) {
  predict(L, t0, dt, Fwd53P{});
  sync();
  update(L, t0, dt, Fwd53U{});
}

template <class Sync>
__device__ void lift_inv(const Line<float>& L, const K97& k, int t0, int dt,
                         Sync sync) {
  scale(L, t0, dt, Mul97{k.k}, Mul97{k.two_over_k});
  sync();
  update(L, t0, dt, Sub97{k.delta});
  sync();
  predict(L, t0, dt, Sub97{k.gamma});
  sync();
  update(L, t0, dt, Sub97{k.beta});
  sync();
  predict(L, t0, dt, Sub97{k.alpha});
}

template <class Sync>
__device__ void lift_inv(const Line<int32_t>& L, const K97&, int t0, int dt,
                         Sync sync) {
  update(L, t0, dt, Inv53U{});
  sync();
  predict(L, t0, dt, Inv53P{});
}

// A line of one sample (dwt_np's single-sample rules): an odd canvas
// sample is a high-pass sample.
__device__ __forceinline__ float single_fwd(float x, int p, const K97& k) {
  return __fmul_rn(x, p ? k.k_half : k.inv_k);
}
__device__ __forceinline__ int32_t single_fwd(int32_t x, int p, const K97&) {
  return p ? x * 2 : x;
}
__device__ __forceinline__ float single_inv(float x, int p, const K97& k) {
  return __fmul_rn(x, p ? k.two_over_k : k.k);
}
__device__ __forceinline__ int32_t single_inv(int32_t x, int p, const K97&) {
  return p ? (x >> 1) : x;
}

// index of canvas-line sample k in the deinterleaved line (lows first)
__device__ __forceinline__ int deint(int k, int p, int ne) {
  return ((p + k) & 1) == 0 ? (k - p) >> 1 : ne + ((k + p) >> 1);
}

__device__ __forceinline__ int n_even(int n, int p) { return (n + 1 - p) >> 1; }

// Forward vertical pass: column x of frame b of `in` (row stride in_rs,
// frame stride in_bs) into the same column of `out` (N, h, w),
// deinterleaved, then lifted in place.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
fwd_v_kernel(const T* __restrict__ in, int64_t in_bs, int64_t in_rs,
             T* __restrict__ out, int N, int h, int w, int p, K97 k) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kColThreads +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(N) * w) return;
  const int b = static_cast<int>(t / w), x = static_cast<int>(t % w);
  const T* src = in + b * in_bs + x;
  T* dst = out + static_cast<int64_t>(b) * h * w + x;
  if (h == 1) {
    dst[0] = single_fwd(src[0], p, k);
    return;
  }
  const int ne = n_even(h, p);
#pragma unroll 8
  for (int r = 0; r < h; ++r) dst[deint(r, p, ne) * int64_t{w}] = src[r * in_rs];
  const Line<T> L{dst, dst + ne * int64_t{w}, w, ne, h - ne, p};
  lift_fwd(L, k, 0, 1, NoSync{});
}

// Working row of a CTA: shared memory when the row fits, else its row of
// the global scratch buffer.
template <typename T>
__device__ __forceinline__ T* work_row(T* scratch, int64_t row, int w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return w <= kSmemFloats ? reinterpret_cast<T*>(smem_raw)
                          : scratch + row * w;
}

// Forward horizontal pass, in place on the rows of buf (N * h rows of w).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
fwd_h_kernel(T* __restrict__ buf, T* __restrict__ scratch, int w, int p,
             K97 k) {
  const int64_t row = blockIdx.x;
  T* line = buf + row * w;
  const int tid = threadIdx.x;
  if (w == 1) {
    if (tid == 0) line[0] = single_fwd(line[0], p, k);
    return;
  }
  T* W = work_row(scratch, row, w);
  const int ne = n_even(w, p);
  for (int c = tid; c < w; c += kRowThreads) W[deint(c, p, ne)] = line[c];
  __syncthreads();
  lift_fwd(Line<T>{W, W + ne, 1, ne, w - ne, p}, k, tid, kRowThreads,
           BlockSync{});
  __syncthreads();
  for (int c = tid; c < w; c += kRowThreads) line[c] = W[c];
}

struct Band {
  const void* p;
  int64_t bs, rs;
};

// Inverse horizontal pass: row y of frame b comes from (LL, HL) for
// y < h_lo and from (LH, HH) below; it is lifted and written interleaved
// to row (b, y) of out (N, h_lo + h_hi, w_lo + w_hi).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
inv_h_kernel(Band ll, Band hl, Band lh, Band hh, T* __restrict__ out,
             T* __restrict__ scratch, int h_lo, int h_hi, int w_lo, int w_hi,
             int p, K97 k) {
  const int64_t row = blockIdx.x;
  const int h = h_lo + h_hi, w = w_lo + w_hi;
  const int b = static_cast<int>(row / h), y = static_cast<int>(row % h);
  const Band& lb = y < h_lo ? ll : lh;
  const Band& hb = y < h_lo ? hl : hh;
  const int yy = y < h_lo ? y : y - h_lo;
  const T* lo = static_cast<const T*>(lb.p) + b * lb.bs + yy * lb.rs;
  const T* hi = static_cast<const T*>(hb.p) + b * hb.bs + yy * hb.rs;
  T* line = out + row * w;
  const int tid = threadIdx.x;
  if (w == 1) {
    if (tid == 0) line[0] = single_inv(w_lo ? lo[0] : hi[0], p, k);
    return;
  }
  T* W = work_row(scratch, row, w);
  for (int c = tid; c < w_lo; c += kRowThreads) W[c] = lo[c];
  for (int c = tid; c < w_hi; c += kRowThreads) W[w_lo + c] = hi[c];
  __syncthreads();
  lift_inv(Line<T>{W, W + w_lo, 1, w_lo, w_hi, p}, k, tid, kRowThreads,
           BlockSync{});
  __syncthreads();
  for (int c = tid; c < w; c += kRowThreads) line[c] = W[deint(c, p, w_lo)];
}

// Inverse vertical pass: column x of frame b of buf (N, h, w; rows
// [0, h_lo) low, the rest high) lifted in place, then written interleaved
// to the same column of out.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
inv_v_kernel(T* __restrict__ buf, T* __restrict__ out, int N, int h, int h_lo,
             int w, int p, K97 k) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kColThreads +
                    threadIdx.x;
  if (t >= static_cast<int64_t>(N) * w) return;
  const int b = static_cast<int>(t / w), x = static_cast<int>(t % w);
  const int64_t base = static_cast<int64_t>(b) * h * w + x;
  T* col = buf + base;
  T* dst = out + base;
  if (h == 1) {
    dst[0] = single_inv(col[0], p, k);
    return;
  }
  lift_inv(Line<T>{col, col + h_lo * int64_t{w}, w, h_lo, h - h_lo, p}, k, 0,
           1, NoSync{});
#pragma unroll 8
  for (int r = 0; r < h; ++r) dst[r * int64_t{w}] = col[deint(r, p, h_lo) * int64_t{w}];
}

K97 load_k(const float* k) {
  return K97{k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]};
}

int col_blocks(int N, int w) {
  return static_cast<int>((static_cast<int64_t>(N) * w + kColThreads - 1) /
                          kColThreads);
}

size_t row_smem(int w) {
  return w <= kSmemFloats ? static_cast<size_t>(w) * 4 : 0;
}

}  // namespace

extern "C" {

// in: frames of (h, w) samples, frame stride in_bs and row stride in_rs
// elements, unit column stride; out: (N, h, w) contiguous. rev: 1 for
// 5/3 on int32, 0 for 9/7 on float32; k: the eight 9/7 constants (alpha,
// beta, gamma, delta, 1/K, K/2, 2/K, K) as float32.
int dwt_fwd_v(const void* in, int64_t in_bs, int64_t in_rs, void* out, int N,
              int h, int w, int parity, int rev, const float* k,
              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rev)
    fwd_v_kernel<int32_t><<<col_blocks(N, w), kColThreads, 0, s>>>(
        static_cast<const int32_t*>(in), in_bs, in_rs,
        static_cast<int32_t*>(out), N, h, w, parity, load_k(k));
  else
    fwd_v_kernel<float><<<col_blocks(N, w), kColThreads, 0, s>>>(
        static_cast<const float*>(in), in_bs, in_rs, static_cast<float*>(out),
        N, h, w, parity, load_k(k));
  return static_cast<int>(cudaGetLastError());
}

// buf: rows (N * h of them, w wide) transformed in place; scratch: at
// least N * h * w elements when w > 12288, else unused.
int dwt_fwd_h(void* buf, void* scratch, int rows, int w, int parity, int rev,
              const float* k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rev)
    fwd_h_kernel<int32_t><<<rows, kRowThreads, row_smem(w), s>>>(
        static_cast<int32_t*>(buf), static_cast<int32_t*>(scratch), w, parity,
        load_k(k));
  else
    fwd_h_kernel<float><<<rows, kRowThreads, row_smem(w), s>>>(
        static_cast<float*>(buf), static_cast<float*>(scratch), w, parity,
        load_k(k));
  return static_cast<int>(cudaGetLastError());
}

// The four bands of one level, each (N, rows, cols) with frame stride
// *_bs and row stride *_rs, unit column stride: LL and HL h_lo rows, LH
// and HH h_hi rows, LL and LH w_lo columns, HL and HH w_hi. out: (N, h_lo
// + h_hi, w_lo + w_hi) contiguous; scratch as for dwt_fwd_h.
int dwt_inv_h(const void* ll, int64_t ll_bs, int64_t ll_rs, const void* hl,
              int64_t hl_bs, int64_t hl_rs, const void* lh, int64_t lh_bs,
              int64_t lh_rs, const void* hh, int64_t hh_bs, int64_t hh_rs,
              void* out, void* scratch, int N, int h_lo, int h_hi, int w_lo,
              int w_hi, int parity, int rev, const float* k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Band bl{ll, ll_bs, ll_rs}, bh{hl, hl_bs, hl_rs}, cl{lh, lh_bs, lh_rs},
      ch{hh, hh_bs, hh_rs};
  const int rows = N * (h_lo + h_hi), w = w_lo + w_hi;
  if (rev)
    inv_h_kernel<int32_t><<<rows, kRowThreads, row_smem(w), s>>>(
        bl, bh, cl, ch, static_cast<int32_t*>(out),
        static_cast<int32_t*>(scratch), h_lo, h_hi, w_lo, w_hi, parity,
        load_k(k));
  else
    inv_h_kernel<float><<<rows, kRowThreads, row_smem(w), s>>>(
        bl, bh, cl, ch, static_cast<float*>(out),
        static_cast<float*>(scratch), h_lo, h_hi, w_lo, w_hi, parity,
        load_k(k));
  return static_cast<int>(cudaGetLastError());
}

// buf: (N, h, w) contiguous, rows [0, h_lo) low and the rest high, lifted
// in place; out: (N, h, w) contiguous, interleaved.
int dwt_inv_v(void* buf, void* out, int N, int h, int h_lo, int w, int parity,
              int rev, const float* k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rev)
    inv_v_kernel<int32_t><<<col_blocks(N, w), kColThreads, 0, s>>>(
        static_cast<int32_t*>(buf), static_cast<int32_t*>(out), N, h, h_lo, w,
        parity, load_k(k));
  else
    inv_v_kernel<float><<<col_blocks(N, w), kColThreads, 0, s>>>(
        static_cast<float*>(buf), static_cast<float*>(out), N, h, h_lo, w,
        parity, load_k(k));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
