// HT decode prepass of the port's host library: expands HT cleanup
// segments into the dense unstuffed stream-word matrices that the CUDA
// decoder (csrc/ht_dec.cu) reads. A copy of grok_ht_dec_prepass from
// grokimagecompression_tpu/native/src/ht.cpp, serial: one loop over the
// lanes, without the original's OpenMP thread-count argument.

#include <cstddef>
#include <cstdint>
#include <vector>

// ---------------------------------------------------------------------------
// Device-decode prepass: expand HT cleanup segments into the dense
// unstuffed stream-word matrices the TPU decoder consumes
// (ops/ht_dec_jax.py _prepass_mel/_prepass_vlc/_prepass_ms — this is a
// bit-identical native mirror; the numpy version's per-byte
// bitwise_or.at scatters dominate fused device-decode wall time).
// Layout: (nwords, B) uint32, C-order (lane b of word w at w*B + b).
// MEL is MSB bit order (stream bit p at word bit 31-(p&31)); VLC and
// MagSgn are LSB order (bit p at word bit p&31). Byte payload widths
// follow each stream's unstuffing rule; the deposit always ORs the
// FULL byte so a 7-bit byte's top bit overlaps the next byte's first
// bit exactly like the forward readers (reference semantics:
// src/lib/jp2/t1/t1_ht/coding/ojph_block_decoder.cpp frwd/rev/MEL
// readers).
// ---------------------------------------------------------------------------

namespace {

struct LaneBuf {
  std::vector<uint32_t> w;
  void reset(int nwords) {
    w.assign((size_t)nwords + 2, 0);  // +2: overlap spill, dropped
  }
  inline void or_lsb_byte(int64_t p, uint32_t v) {
    uint64_t x = (uint64_t)v << (p & 31);
    w[(size_t)(p >> 5)] |= (uint32_t)x;
    w[(size_t)(p >> 5) + 1] |= (uint32_t)(x >> 32);
  }
  inline void or_msb_byte(int64_t p, uint32_t v) {
    // byte MSB-first starting at stream position p
    uint64_t x = (uint64_t)v << (56 - (p & 31));
    w[(size_t)(p >> 5)] |= (uint32_t)(x >> 32);
    w[(size_t)(p >> 5) + 1] |= (uint32_t)x;
  }
  void ones_from_lsb(int64_t p, int nwords) {
    int64_t nbits = (int64_t)nwords * 32;
    if (p >= nbits) return;
    w[(size_t)(p >> 5)] |= ~(((uint32_t)1 << (p & 31)) - 1);
    for (int64_t k = (p >> 5) + 1; k < nwords; k++) w[(size_t)k] = ~0u;
  }
  void ones_from_msb(int64_t p, int nwords) {
    int64_t nbits = (int64_t)nwords * 32;
    if (p >= nbits) return;
    w[(size_t)(p >> 5)] |= ((uint64_t)1 << (32 - (p & 31))) - 1;
    for (int64_t k = (p >> 5) + 1; k < nwords; k++) w[(size_t)k] = ~0u;
  }
  void store(uint32_t* out, int nwords, int B, int lane) const {
    for (int k = 0; k < nwords; k++) out[(size_t)k * B + lane] = w[k];
  }
};

}  // namespace

extern "C" {

// segs concatenated in `data`; segment i is data[offs[i]..offs[i+1]).
// Caller zero-fills the three output matrices.
int grok_ht_dec_prepass(const uint8_t* data, const int64_t* offs,
                        const int32_t* lcups, const int32_t* scups, int B,
                        int wm_mel, int wm_vlc, int wm_ms,
                        uint32_t* out_mel, uint32_t* out_vlc,
                        uint32_t* out_ms) {
  LaneBuf buf;
  for (int i = 0; i < B; i++) {
    const uint8_t* seg = data + offs[i];
    const int lcup = lcups[i], scup = scups[i];

    // ---- MEL: forward from lcup-scup, MSB deposit, 0xFF pad, last
    // real byte's low nibble forced to 0xF ----
    buf.reset(wm_mel);
    {
      const uint8_t* p = seg + (lcup - scup);
      const int n = scup - 1;
      int64_t pos = 0;
      bool unstuff = false;
      const int64_t nbits = (int64_t)wm_mel * 32;
      for (int j = 0; j < n && pos < nbits; j++) {
        unsigned d = p[j];
        if (j == n - 1) d |= 0xF;
        int dbits = unstuff ? 7 : 8;
        buf.or_msb_byte(pos - (8 - dbits), d);  // j=0: dbits=8, start 0
        pos += dbits;
        unstuff = d == 0xFF;
      }
      buf.ones_from_msb(pos < 0 ? 0 : pos, wm_mel);
      buf.store(out_mel, wm_mel, B, i);
    }

    // ---- VLC: initial high nibble of seg[lcup-2] (4 bits, 3 when its
    // low 3 bits are 111), then bytes BACKWARD from lcup-3; zero pad ----
    buf.reset(wm_vlc);
    {
      const unsigned d0 = seg[lcup - 2];
      const unsigned nib = d0 >> 4;
      int64_t pos = 0;
      buf.or_lsb_byte(0, nib);
      pos += 4 - (((nib & 7) == 7) ? 1 : 0);
      bool unstuff = (d0 | 0xF) > 0x8F;
      const int n = scup - 2;
      const int64_t nbits = (int64_t)wm_vlc * 32;
      for (int j = 0; j < n && pos < nbits; j++) {
        unsigned d = seg[lcup - 3 - j];
        int dbits = (unstuff && (d & 0x7F) == 0x7F) ? 7 : 8;
        buf.or_lsb_byte(pos, d);
        pos += dbits;
        unstuff = d > 0x8F;
      }
      buf.store(out_vlc, wm_vlc, B, i);
    }

    // ---- MagSgn: forward bytes 0..lcup-scup, LSB deposit, 0xFF pad ----
    buf.reset(wm_ms);
    {
      const int n = lcup - scup;
      int64_t pos = 0;
      bool unstuff = false;
      const int64_t nbits = (int64_t)wm_ms * 32;
      for (int j = 0; j < n && pos < nbits; j++) {
        unsigned d = seg[j];
        int dbits = unstuff ? 7 : 8;
        buf.or_lsb_byte(pos, d);
        pos += dbits;
        unstuff = d == 0xFF;
      }
      buf.ones_from_lsb(pos < 0 ? 0 : pos, wm_ms);
      buf.store(out_ms, wm_ms, B, i);
    }
  }
  return 0;
}

}  // extern "C"
