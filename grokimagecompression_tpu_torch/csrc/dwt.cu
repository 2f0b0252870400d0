// Multi-level 2-D discrete wavelet transform (5/3 on int32, 9/7 on float32)
// for Hopper (sm_90a): one tiled launch per level and direction.
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
// Left out of the TPU formulation: the lifting at stride 2^level with iota
// masks over the whole tile, the halo striping and the VMEM budget. They
// exist for the TPU's vector unit and its fast memory.
//
// What bounds it: bytes. A 9/7 level costs about 14 float operations a
// sample against 8 bytes moved at least, far below the card's ratio of
// operations to bytes. So a level is one launch that reads its region
// once and writes its four bands once:
//   - a CTA takes a tile of tile x tile samples of the level's region with
//     a halo of kHalo = 4 samples on each side (the reach of the four 9/7
//     lifting steps; 5/3 needs 2 and takes the same halo, which keeps the
//     tile's rows 16-byte aligned) into shared memory; interior tiles
//     whose rows are 16-byte aligned arrive by cp.async, the others by
//     plain loads;
//   - past the region's true edges the halo holds the symmetric extension
//     (whole-sample mirroring, which is what dwt_np's clamped neighbours
//     are, and which the lifting steps preserve); an interior tile edge
//     reads its real neighbours, and neighbouring tiles recompute the
//     halo, so no CTA waits on another;
//   - forward: the vertical lifting steps on every column of the tile,
//     then the horizontal ones on its core rows (dwt_np's order), in
//     place in shared memory, each step one pass of the CTA's threads
//     with a barrier after it; the core goes out once, deinterleaved, each
//     sample to its band (LL to its own buffer, HL / LH / HH to their
//     places in the level's region of the output, low rows above high
//     rows and low columns left of high columns), half-rows of the tile
//     contiguous;
//   - inverse: the tile gathered from the four bands, the horizontal
//     steps on every row, then the vertical ones on the core columns, and
//     the core written interleaved, whole rows contiguous;
//   - the wrapper picks the tile (64, 32 or 16) per level so that a level
//     has enough CTAs to fill the SMs;
//   - one host call launches a whole transform's levels, so a transform
//     costs one ctypes call, not one a level.
//
// Plain C interface (bound with ctypes): every entry point launches on the
// given stream and returns the first launch error, or 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalo = 4;
constexpr int kTx = 32, kTy = 8;   // threads of a CTA: columns x rows

struct K97 {
  float alpha, beta, gamma, delta, inv_k, k_half, two_over_k, k;
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

// the 9/7 scaling of a sample of canvas parity `odd` (forward: low 1/K,
// high K/2; inverse: low K, high 2/K); 5/3 has none
__device__ __forceinline__ float scale_fwd(float x, int odd, const K97& k) {
  return __fmul_rn(x, odd ? k.k_half : k.inv_k);
}
__device__ __forceinline__ float scale_inv(float x, int odd, const K97& k) {
  return __fmul_rn(x, odd ? k.two_over_k : k.k);
}

__device__ __forceinline__ int n_even(int n, int p) { return (n + 1 - p) >> 1; }

// index of canvas-line sample k in the deinterleaved line (lows first)
__device__ __forceinline__ int deint(int k, int p, int ne) {
  return ((p + k) & 1) == 0 ? (k - p) >> 1 : ne + ((k + p) >> 1);
}

// sample k of a line of n under whole-sample symmetric extension at both
// ends (period 2 (n - 1))
__device__ __forceinline__ int mirror(int k, int n) {
  if (k >= 0 && k < n) return k;
  if (n == 1) return 0;
  const int P = 2 * (n - 1);
  k %= P;
  if (k < 0) k += P;
  return k < n ? k : P - k;
}

struct Plane {
  const void* p;
  int64_t bs, rs;   // frame and row strides, in elements
};

// The tile in shared memory: (eh, ew) samples at row stride S, tile row i
// / column c at region row o_y - kHalo + i / column o_x - kHalo + c.
template <typename T>
struct Tile {
  T* s;
  int S, eh, ew;
  int oy, ox;    // the core's first region row and column
  int py, px;    // the level's canvas parity
  __device__ __forceinline__ T& at(int i, int c) const { return s[i * S + c]; }
  // canvas parity (1: odd, a high-pass sample) of tile row i / column c
  __device__ __forceinline__ int row_odd(int i) const {
    return (py + oy - kHalo + i) & 1;
  }
  __device__ __forceinline__ int col_odd(int c) const {
    return (px + ox - kHalo + c) & 1;
  }
  // the first tile row (column) >= 1 of parity `odd`
  __device__ __forceinline__ int first_row(int odd) const {
    return row_odd(1) == odd ? 1 : 2;
  }
  __device__ __forceinline__ int first_col(int odd) const {
    return col_odd(1) == odd ? 1 : 2;
  }

  // one vertical lifting step on the rows of parity `odd` in [1, eh - 1)
  // and the columns [c0, c1)
  template <class F>
  __device__ __forceinline__ void vstep(int odd, int c0, int c1, F f) const {
    for (int i = first_row(odd) + 2 * threadIdx.y; i < eh - 1; i += 2 * kTy)
      for (int c = c0 + threadIdx.x; c < c1; c += kTx)
        at(i, c) = f(at(i, c), at(i - 1, c), at(i + 1, c));
    __syncthreads();
  }
  // one horizontal lifting step on the rows [r0, r1) and the columns of
  // parity `odd` in [1, ew - 1)
  template <class F>
  __device__ __forceinline__ void hstep(int odd, int r0, int r1, F f) const {
    for (int i = r0 + threadIdx.y; i < r1; i += kTy)
      for (int c = first_col(odd) + 2 * threadIdx.x; c < ew - 1; c += 2 * kTx)
        at(i, c) = f(at(i, c), at(i, c - 1), at(i, c + 1));
    __syncthreads();
  }
  // x = f(x, i, c) on rows [r0, r1) and columns [c0, c1)
  template <class F>
  __device__ __forceinline__ void each(int r0, int r1, int c0, int c1,
                                       F f) const {
    for (int i = r0 + threadIdx.y; i < r1; i += kTy)
      for (int c = c0 + threadIdx.x; c < c1; c += kTx)
        at(i, c) = f(at(i, c), i, c);
    __syncthreads();
  }
};

// Forward lifting of the tile's columns [c0, c1) (vertical) or rows [r0,
// r1) (horizontal); `n` is the region's extent along the lifted axis.
__device__ void lift_fwd_v(const Tile<float>& t, int n, int c0, int c1,
                           int r0, int r1, const K97& k) {
  if (n == 1) {
    t.each(r0, r1, c0, c1, [&](float x, int, int) {
      return single_fwd(x, t.py, k); });
    return;
  }
  t.vstep(1, c0, c1, Add97{k.alpha});
  t.vstep(0, c0, c1, Add97{k.beta});
  t.vstep(1, c0, c1, Add97{k.gamma});
  t.vstep(0, c0, c1, Add97{k.delta});
  t.each(r0, r1, c0, c1, [&](float x, int i, int) {
    return scale_fwd(x, t.row_odd(i), k); });
}
__device__ void lift_fwd_v(const Tile<int32_t>& t, int n, int c0, int c1,
                           int r0, int r1, const K97& k) {
  if (n == 1) {
    t.each(r0, r1, c0, c1, [&](int32_t x, int, int) {
      return single_fwd(x, t.py, k); });
    return;
  }
  t.vstep(1, c0, c1, Fwd53P{});
  t.vstep(0, c0, c1, Fwd53U{});
}
__device__ void lift_fwd_h(const Tile<float>& t, int n, int r0, int r1,
                           int c0, int c1, const K97& k) {
  if (n == 1) {
    t.each(r0, r1, c0, c1, [&](float x, int, int) {
      return single_fwd(x, t.px, k); });
    return;
  }
  t.hstep(1, r0, r1, Add97{k.alpha});
  t.hstep(0, r0, r1, Add97{k.beta});
  t.hstep(1, r0, r1, Add97{k.gamma});
  t.hstep(0, r0, r1, Add97{k.delta});
  t.each(r0, r1, c0, c1, [&](float x, int, int c) {
    return scale_fwd(x, t.col_odd(c), k); });
}
__device__ void lift_fwd_h(const Tile<int32_t>& t, int n, int r0, int r1,
                           int c0, int c1, const K97& k) {
  if (n == 1) {
    t.each(r0, r1, c0, c1, [&](int32_t x, int, int) {
      return single_fwd(x, t.px, k); });
    return;
  }
  t.hstep(1, r0, r1, Fwd53P{});
  t.hstep(0, r0, r1, Fwd53U{});
}

// Inverse lifting, the same way round.
__device__ void lift_inv_h(const Tile<float>& t, int n, int r0, int r1,
                           const K97& k) {
  if (n == 1) {
    t.each(r0, r1, 0, t.ew, [&](float x, int, int) {
      return single_inv(x, t.px, k); });
    return;
  }
  t.each(r0, r1, 0, t.ew, [&](float x, int, int c) {
    return scale_inv(x, t.col_odd(c), k); });
  t.hstep(0, r0, r1, Sub97{k.delta});
  t.hstep(1, r0, r1, Sub97{k.gamma});
  t.hstep(0, r0, r1, Sub97{k.beta});
  t.hstep(1, r0, r1, Sub97{k.alpha});
}
__device__ void lift_inv_h(const Tile<int32_t>& t, int n, int r0, int r1,
                           const K97& k) {
  if (n == 1) {
    t.each(r0, r1, 0, t.ew, [&](int32_t x, int, int) {
      return single_inv(x, t.px, k); });
    return;
  }
  t.hstep(0, r0, r1, Inv53U{});
  t.hstep(1, r0, r1, Inv53P{});
}
__device__ void lift_inv_v(const Tile<float>& t, int n, int c0, int c1,
                           const K97& k) {
  if (n == 1) {
    t.each(0, t.eh, c0, c1, [&](float x, int, int) {
      return single_inv(x, t.py, k); });
    return;
  }
  t.each(0, t.eh, c0, c1, [&](float x, int i, int) {
    return scale_inv(x, t.row_odd(i), k); });
  t.vstep(0, c0, c1, Sub97{k.delta});
  t.vstep(1, c0, c1, Sub97{k.gamma});
  t.vstep(0, c0, c1, Sub97{k.beta});
  t.vstep(1, c0, c1, Sub97{k.alpha});
}
__device__ void lift_inv_v(const Tile<int32_t>& t, int n, int c0, int c1,
                           const K97& k) {
  if (n == 1) {
    t.each(0, t.eh, c0, c1, [&](int32_t x, int, int) {
      return single_inv(x, t.py, k); });
    return;
  }
  t.vstep(0, c0, c1, Inv53U{});
  t.vstep(1, c0, c1, Inv53P{});
}

__device__ __forceinline__ void cp_async16(void* smem, const void* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g));
}

// The CTA's tile of a (N, h, w) region: blockIdx.x the tile, blockIdx.y
// the frame.
template <typename T>
__device__ __forceinline__ Tile<T> tile_of(int h, int w, int py, int px,
                                           int tile, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile<T> t;
  t.s = reinterpret_cast<T*>(smem_raw);
  t.S = tile + 2 * kHalo;
  t.oy = (blockIdx.x / tiles_x) * tile;
  t.ox = (blockIdx.x % tiles_x) * tile;
  t.eh = min(tile, h - t.oy) + 2 * kHalo;
  t.ew = min(tile, w - t.ox) + 2 * kHalo;
  t.py = py;
  t.px = px;
  return t;
}

// Forward level: the region (N, h, w) of `in` (frame stride in.bs, row
// stride in.rs, unit columns) into its four bands: LL (hl x wl) to `ll`,
// HL, LH and HH to their places in the (h, w) region of `out` (rows
// [0, hl) low, columns [0, wl) low). `async_ok`: in's base, strides and
// tile columns allow 16-byte copies.
template <typename T>
__global__ void __launch_bounds__(kTx * kTy)
fwd_kernel(Plane in, Plane ll, Plane out, int h, int w, int py, int px,
           int tile, int tiles_x, int async_ok, K97 k) {
  const Tile<T> t = tile_of<T>(h, w, py, px, tile, tiles_x);
  const int64_t b = blockIdx.y;
  const T* src = static_cast<const T*>(in.p) + b * in.bs;
  const int ch = t.eh - 2 * kHalo, cw = t.ew - 2 * kHalo;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  if (async_ok && t.ox >= kHalo && t.ox + cw + kHalo <= w) {
    const int v = t.ew / 4;   // 16-byte pieces a row
    for (int q = tid; q < t.eh * v; q += kTx * kTy) {
      const int i = q / v, c = 4 * (q % v);
      const int r = mirror(t.oy - kHalo + i, h);
      cp_async16(&t.at(i, c), src + r * in.rs + t.ox - kHalo + c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    for (int i = threadIdx.y; i < t.eh; i += kTy) {
      const T* row = src + mirror(t.oy - kHalo + i, h) * in.rs;
      for (int c = threadIdx.x; c < t.ew; c += kTx)
        t.at(i, c) = row[mirror(t.ox - kHalo + c, w)];
    }
  }
  __syncthreads();
  // vertical: every column (the horizontal steps read the halo columns);
  // horizontal: the core rows
  lift_fwd_v(t, h, 0, t.ew, kHalo, kHalo + ch, k);
  lift_fwd_h(t, w, kHalo, kHalo + ch, kHalo, kHalo + cw, k);

  // out: each core row's lows, then its highs, each run contiguous
  const int hl = n_even(h, py), wl = n_even(w, px);
  const int p0 = (px + t.ox) & 1;             // the core's first column odd?
  const int nlo = n_even(cw, p0);
  const int lo0 = t.ox + p0, hi0 = t.ox + 1 - p0;
  for (int i = threadIdx.y; i < ch; i += kTy) {
    const int orow = deint(t.oy + i, py, hl);
    const Plane& d = orow < hl ? ll : out;
    T* drow = static_cast<T*>(const_cast<void*>(d.p)) + b * d.bs +
              orow * d.rs;
    T* orow_out = static_cast<T*>(const_cast<void*>(out.p)) + b * out.bs +
                  orow * out.rs;
    for (int j = threadIdx.x; j < cw; j += kTx) {
      const int col = j < nlo ? lo0 + 2 * j : hi0 + 2 * (j - nlo);
      const int ocol = deint(col, px, wl);
      const T x = t.at(kHalo + i, kHalo + col - t.ox);
      if (ocol < wl)
        drow[ocol] = x;
      else
        orow_out[ocol] = x;
    }
  }
}

// Inverse level: the four bands (LL and HL h_lo rows, LH and HH h_hi;
// LL and LH w_lo columns, HL and HH w_hi) into the interleaved (h, w)
// region of `out`.
template <typename T>
__global__ void __launch_bounds__(kTx * kTy)
inv_kernel(Plane ll, Plane hl, Plane lh, Plane hh, Plane out, int h_lo,
           int h_hi, int w_lo, int w_hi, int py, int px, int tile,
           int tiles_x, K97 k) {
  const int h = h_lo + h_hi, w = w_lo + w_hi;
  const Tile<T> t = tile_of<T>(h, w, py, px, tile, tiles_x);
  const int64_t b = blockIdx.y;
  const int ch = t.eh - 2 * kHalo, cw = t.ew - 2 * kHalo;
  for (int i = threadIdx.y; i < t.eh; i += kTy) {
    const int r = mirror(t.oy - kHalo + i, h);
    const bool odd_r = (py + r) & 1;
    const int rr = odd_r ? (r + py) >> 1 : (r - py) >> 1;
    const Plane& lo = odd_r ? lh : ll;
    const Plane& hi = odd_r ? hh : hl;
    const T* lrow = static_cast<const T*>(lo.p) + b * lo.bs + rr * lo.rs;
    const T* hrow = static_cast<const T*>(hi.p) + b * hi.bs + rr * hi.rs;
    for (int c = threadIdx.x; c < t.ew; c += kTx) {
      const int col = mirror(t.ox - kHalo + c, w);
      t.at(i, c) = (px + col) & 1 ? hrow[(col + px) >> 1]
                                  : lrow[(col - px) >> 1];
    }
  }
  __syncthreads();
  // horizontal: every row (the vertical steps read the halo rows);
  // vertical: the core columns
  lift_inv_h(t, w, 0, t.eh, k);
  lift_inv_v(t, h, kHalo, kHalo + cw, k);
  T* dst = static_cast<T*>(const_cast<void*>(out.p)) + b * out.bs;
  for (int i = threadIdx.y; i < ch; i += kTy)
    for (int c = threadIdx.x; c < cw; c += kTx)
      dst[(t.oy + i) * out.rs + t.ox + c] = t.at(kHalo + i, kHalo + c);
}

K97 load_k(const float* k) {
  return K97{k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]};
}

dim3 grid_of(int N, int h, int w, int tile, int& tiles_x) {
  tiles_x = (w + tile - 1) / tile;
  return dim3(static_cast<unsigned>(tiles_x * ((h + tile - 1) / tile)),
              static_cast<unsigned>(N));
}

size_t smem_of(int tile) {
  const size_t e = static_cast<size_t>(tile) + 2 * kHalo;
  return e * e * 4;
}

}  // namespace

extern "C" {

// The forward transform, one launch per level: in (N, h, w) at frame
// stride in_bs and row stride in_rs elements, unit column stride; out:
// (N, h, w) contiguous, the Mallat layout (level l's region its top-left
// corner); scratch: the LL bands between levels, level l's at element
// (l odd ? slot1 : 0), contiguous. lv: per level (py, px, tile): its
// canvas origin parity and tile side (16, 32 or 64). rev: 1 for 5/3 on
// int32, 0 for 9/7 on float32; k: the eight 9/7 constants (alpha, beta,
// gamma, delta, 1/K, K/2, 2/K, K) as float32.
int dwt_fwd(const void* in, int64_t in_bs, int64_t in_rs, void* out,
            void* scratch, int64_t slot1, int N, int h, int w, int nl,
            const int* lv, int rev, const float* k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const K97 kk = load_k(k);
  const int64_t H = h, W = w;
  Plane cur{in, in_bs, in_rs};
  for (int l = 0; l < nl; ++l) {
    const int py = lv[3 * l], px = lv[3 * l + 1], tile = lv[3 * l + 2];
    const int hl = (h + 1 - py) >> 1, wl = (w + 1 - px) >> 1;
    const Plane po{out, H * W, W};
    const Plane pl =
        l == nl - 1
            ? po
            : Plane{static_cast<char*>(scratch) + 4 * (l % 2 ? slot1 : 0),
                    int64_t{hl} * wl, wl};
    if (N > 0 && h > 0 && w > 0) {
      int tiles_x;
      const dim3 grid = grid_of(N, h, w, tile, tiles_x);
      const int async_ok = (reinterpret_cast<uintptr_t>(cur.p) & 15) == 0 &&
                           cur.bs % 4 == 0 && cur.rs % 4 == 0;
      if (rev)
        fwd_kernel<int32_t><<<grid, dim3(kTx, kTy), smem_of(tile), s>>>(
            cur, pl, po, h, w, py, px, tile, tiles_x, async_ok, kk);
      else
        fwd_kernel<float><<<grid, dim3(kTx, kTy), smem_of(tile), s>>>(
            cur, pl, po, h, w, py, px, tile, tiles_x, async_ok, kk);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cur = pl;
    h = hl;
    w = wl;
  }
  return 0;
}

// The inverse transform up to its level R, one launch per level. ll: the
// LL band (N, h, w) at its strides; bands: per level r = 1..R the HL, LH
// and HH bands as (pointer, frame stride, row stride) triples, 9 values
// a level, unit column strides; lv: per level (h_hi, w_hi, py, px, tile):
// the rows of LH and HH, the columns of HL and HH, the level's canvas
// origin parity and tile side. Level r writes (N, h_r, w_r) contiguous to
// `out` when R - r is even, else to `scratch`, so level R lands in out.
int dwt_inv(const void* ll, int64_t ll_bs, int64_t ll_rs,
            const int64_t* bands, void* out, void* scratch, int N, int h,
            int w, int R, const int* lv, int rev, const float* k,
            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const K97 kk = load_k(k);
  Plane cur{ll, ll_bs, ll_rs};
  for (int r = 0; r < R; ++r) {
    const int64_t* b = bands + 9 * r;
    const Plane hl{reinterpret_cast<const void*>(b[0]), b[1], b[2]},
        lh{reinterpret_cast<const void*>(b[3]), b[4], b[5]},
        hh{reinterpret_cast<const void*>(b[6]), b[7], b[8]};
    const int* v = lv + 5 * r;
    const int h_hi = v[0], w_hi = v[1], py = v[2], px = v[3], tile = v[4];
    const int hr = h + h_hi, wr = w + w_hi;
    const Plane po{(R - 1 - r) % 2 == 0 ? out : scratch, int64_t{hr} * wr,
                   wr};
    if (N > 0 && hr > 0 && wr > 0) {
      int tiles_x;
      const dim3 grid = grid_of(N, hr, wr, tile, tiles_x);
      if (rev)
        inv_kernel<int32_t><<<grid, dim3(kTx, kTy), smem_of(tile), s>>>(
            cur, hl, lh, hh, po, h, h_hi, w, w_hi, py, px, tile, tiles_x,
            kk);
      else
        inv_kernel<float><<<grid, dim3(kTx, kTy), smem_of(tile), s>>>(
            cur, hl, lh, hh, po, h, h_hi, w, w_hi, py, px, tile, tiles_x,
            kk);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cur = po;
    h = hr;
    w = wr;
  }
  return 0;
}

}  // extern "C"
