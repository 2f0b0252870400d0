"""Build and load the port's native code: CUDA kernels and host library.

The CUDA kernels live in `grokimagecompression_tpu_torch/csrc/*.cu` and
are compiled on first use with nvcc into `build/torch_kernels/` at the
repository root (listed in .gitignore) with a plain C interface, then
bound with ctypes: pointers and the stream are `c_void_p`, ints are
`c_int`, and every entry point returns `cudaGetLastError()` after its
launch.

The host library (`csrc/host/*.cpp`: native T2, the HT block coder with
its refinement passes and the HT decode prepass, the PNG scanline
filters and the Tier-1 MQ coder, copies of the reference's native
sources) is compiled on first use with g++ into `build/torch_host/`,
without OpenMP; only the Tier-1 and HT batch entries run on worker
threads (std::thread, the count passed in by the caller).

Both builds write to a private file and rename it into place, so
concurrent processes never load a half-written library; a failed build
raises. Nothing is compiled or loaded at import time: the CPU tests
import every module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
from typing import Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

SOURCES = ("ht_enc.cu", "ht_dec.cu", "mq_scan.cu", "mq_dense.cu", "mq_dec.cu",
           "dwt.cu")
HEADERS = ("mq_tables.cuh", "mq_coder.cuh")
# flags of single sources: the DWT's float32 lifting must not be
# contracted into FMAs (bit-exactness with dwt_np)
SOURCE_FLAGS = {"dwt.cu": ("--fmad=false",)}
LIBRARY = os.path.join(BUILD_DIR, "libgrok_kernels.so")

HOST_CSRC = os.path.join(CSRC, "host")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_host")
HOST_LIBRARY = os.path.join(HOST_BUILD_DIR, "libgrok_host.so")
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _compile(out: str, deps, compile_cmd) -> str:
    """Run `compile_cmd(tmp)` into a private file next to `out` and
    rename it into place, unless `out` is newer than every path in
    `deps`. Returns the compiler's output (empty when up to date)."""
    if os.path.exists(out) and all(
            os.path.getmtime(out) >= os.path.getmtime(d) for d in deps):
        return ""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cmd = compile_cmd(tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def build() -> Tuple[str, str]:
    """Compile the kernel library if missing or older than its sources:
    one nvcc per source, all started together, then one link. Returns
    (path to the .so, compiler output; empty when up to date)."""
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    if os.path.exists(LIBRARY) and all(
            os.path.getmtime(LIBRARY) >= os.path.getmtime(s)
            for s in srcs + [os.path.join(CSRC, f) for f in HEADERS]):
        return LIBRARY, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for s in srcs:
        fd, obj = tempfile.mkstemp(suffix=".o", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3",
               *SOURCE_FLAGS.get(os.path.basename(s), ()), "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-c", "-o", obj, s]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        log.append(_compile(LIBRARY, (), lambda tmp: [
            nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]))
    finally:
        for o in objs:
            os.unlink(o)
    return LIBRARY, "".join(log)


def build_host() -> Tuple[str, str]:
    """Compile the host library from `csrc/host/*.cpp` with g++ if
    missing or older than its sources. Returns (path, compiler output)."""
    srcs = sorted(os.path.join(HOST_CSRC, f) for f in os.listdir(HOST_CSRC)
                  if f.endswith(".cpp"))
    deps = [os.path.join(HOST_CSRC, f) for f in os.listdir(HOST_CSRC)]
    log = _compile(HOST_LIBRARY, deps, lambda tmp: [
        "g++", *HOST_FLAGS, "-o", tmp, *srcs])
    return HOST_LIBRARY, log


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """Build (if needed) and load the host library, with every entry
    point's argtypes/restype declared."""
    path, _ = build_host()
    lib = ctypes.CDLL(path)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # (ngroups, numlayers, max_layer, eph, g_nbands, grid, ncblks, meta,
    #  layer_np, rates, term, pass_stride, data, out, group_off,
    #  frag_off)
    lib.grok_t2_encode_tile.restype = I
    lib.grok_t2_encode_tile.argtypes = [I, I, I, I, P, P, P, P, P, P, P, I,
                                        P, P, P, P]
    # (ngroups, numlayers, max_layer, eph, g_nbands, grid, ncblks, meta,
    #  layer_np, rates, term, pass_stride, out_bytes)
    lib.grok_t2_simulate_tile.restype = I
    lib.grok_t2_simulate_tile.argtypes = [I, I, I, I, P, P, P, P, P, P, P, I,
                                          P]
    # (body, body_len, npackets, pkt_group, pkt_layer, ngroups, gband_off,
    #  grid, ncblks, kmax, style, meta, sop, eph, nlayers, out_meta,
    #  seg_out, seg_cap)
    lib.grok_t2_decode_tile.restype = L
    lib.grok_t2_decode_tile.argtypes = [P, L, I, P, P, I, P, P, P, P, P, P,
                                        I, I, I, P, P, L]
    # (data, offs, lcups, scups, B, wm_mel, wm_vlc, wm_ms, out_mel,
    #  out_vlc, out_ms)
    lib.grok_ht_dec_prepass.restype = I
    lib.grok_ht_dec_prepass.argtypes = [P, P, P, P, I, I, I, I, P, P, P]
    # (rows, nrows, rowbytes, bpp, out)
    lib.grok_png_unfilter.restype = I
    lib.grok_png_unfilter.argtypes = [P, I, I, I, P]
    # (img, nrows, rowbytes, bpp, filter, out)
    lib.grok_png_filter.restype = I
    lib.grok_png_filter.argtypes = [P, I, I, I, I, P]
    # (mag, neg, w, h, orient, style, out, cap, meta, rates, dist, term)
    lib.grok_t1_encode.restype = I
    lib.grok_t1_encode.argtypes = [P, P, I, I, I, I, P, I, P, P, P, P]
    # (data, len, seg_lens, nsegs, w, h, orient, numbps, numpasses, style,
    #  mag, neg)
    lib.grok_t1_decode.restype = I
    lib.grok_t1_decode.argtypes = [P, I, P, I, I, I, I, I, I, I, P, P]
    # (n, mag, neg, desc, style, out, out_stride, meta, rates, dist, term,
    #  pass_stride, nthreads)
    lib.grok_t1_encode_batch.restype = I
    lib.grok_t1_encode_batch.argtypes = [I, P, P, P, I, P, I, P, P, P, P, I,
                                         I]
    # (n, data, seg_lens, desc, mag, neg, nthreads, signed_out)
    lib.grok_t1_decode_batch.restype = I
    lib.grok_t1_decode_batch.argtypes = [I, P, P, P, P, P, I, I]
    # (n, data, seg_lens, desc, band_ptrs, band_strides, steps, is_float,
    #  nthreads)
    lib.grok_t1_decode_bands.restype = I
    lib.grok_t1_decode_bands.argtypes = [I, P, P, P, P, P, P, I, I]
    # (n, band_ptrs, band_strides, desc, mag, neg, nthreads)
    lib.grok_extract_blocks.restype = I
    lib.grok_extract_blocks.argtypes = [I, P, P, P, P, P, I]
    # (n, band_ptrs, band_strides, steps, desc, mag, neg, nthreads)
    lib.grok_extract_blocks_f32.restype = I
    lib.grok_extract_blocks_f32.argtypes = [I, P, P, P, P, P, P, I]
    # (mag, neg, w, h, Mb, passes, out, cap, len1, len2)
    lib.grok_ht_encode_refined.restype = I
    lib.grok_ht_encode_refined.argtypes = [P, P, I, I, I, I, P, I, P, P]
    # (data, len1, len2, passes, w, h, Mb, quarters, neg)
    lib.grok_ht_decode_refined.restype = I
    lib.grok_ht_decode_refined.argtypes = [P, I, I, I, I, I, I, P, P]
    # (n, band_ptrs, band_strides, steps, is_float, desc5, mbs, passes,
    #  out, out_stride, len1, len2, nthreads)
    lib.grok_ht_encode_refined_bands.restype = I
    lib.grok_ht_encode_refined_bands.argtypes = [I, P, P, P, I, P, P, I, P,
                                                 I, P, P, I]
    # (n, data, desc, band_ptrs, band_strides, steps, is_float, nthreads)
    for fn in (lib.grok_ht_decode_bands, lib.grok_ht_decode_refined_bands):
        fn.restype = I
        fn.argtypes = [I, P, P, P, P, P, I, I]
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argtypes/restype declared."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    # (coeffs, mbs, tbl, off, out, lens, lanes, qh, qw, m_max, stream)
    lib.ht_enc_group.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.ht_enc_group.restype = ctypes.c_int
    # (src, off, lens, ends, dst, lanes, stream)
    lib.ht_enc_pack.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int,
                                                        ctypes.c_void_p]
    lib.ht_enc_pack.restype = ctypes.c_int
    # (data, off, lcup, scup, order, lanes, w, h, dec0, dec1, mags, signs,
    #  stalled, stream)
    lib.ht_dec_group.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 6
    lib.ht_dec_group.restype = ctypes.c_int
    # (slots, T, lanes, seg_off, out, lens, state, cumbo, sa, sb, tp,
    #  stream)
    lib.mq_scan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.mq_scan.restype = ctypes.c_int
    # (slots, T, T_out, lanes, words, m8, nbo, state, stream)
    lib.mq_scan_dense.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 5
    lib.mq_scan_dense.restype = ctypes.c_int
    # (data, off, nbps, npas, ori, order, B, w, h, out, stats, stream)
    lib.mq_dec_group.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 3
    lib.mq_dec_group.restype = ctypes.c_int
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # (in, in_bs, in_rs, out, scratch, slot1, N, h, w, levels, lv, rev, k,
    #  stream)
    lib.dwt_fwd.argtypes = [P, L, L, P, P, L] + [I] * 4 + [P, I, P, P]
    # (ll, ll_bs, ll_rs, bands, out, scratch, N, h, w, levels, lv, rev, k,
    #  stream)
    lib.dwt_inv.argtypes = [P, L, L, P, P, P] + [I] * 4 + [P, I, P, P]
    for fn in (lib.dwt_fwd, lib.dwt_inv):
        fn.restype = ctypes.c_int
    return lib
