// Native Tier-2 packet encoder and parser of the port's host library.
// A copy of grokimagecompression_tpu/native/src/t2.cpp: the whole-tile
// encoder (grok_t2_encode_tile), the whole-tile packet simulator of the
// rate control (grok_t2_simulate_tile) and the whole-tile packet parser
// (grok_t2_decode_tile). The native convex hull (grok_rc_hulls) is not
// copied: the port's pcrd.py runs the Python hull it is the copy of.
// Built with g++ (ops/_build.host_library). The tile encoder and the
// simulator are serial: one loop over the groups, without the original's
// OpenMP parallel loop and thread-count argument.
//
// The encoder emits all layers' packets for each precinct group (the 1
// or 3 band-precincts a packet covers).
//
// Bit-identical to the Python reference (codestream/t2.py encode_packet,
// tagtree.py, bitio.py), which follows ISO/IEC 15444-1 B.10 (reference
// behavior: src/lib/jp2/t2/T2.cpp encode_packet:859,
// codestream/TagTree.cpp:230, BitIO.h).  Inter-packet T2 state (tag
// trees, inclusion, Lblock, consumed passes) is per-precinct, so holding
// it inside a single native call over the layer loop reproduces the
// packet-by-packet state evolution exactly.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int T2_INF = 999999999;

// ---------------------------------------------------------------------------
// Bit writer with 0xFF stuffing (packet headers).
// ---------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t>& out;
  int buf = 0, ct = 8;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  void emit() {
    out.push_back((uint8_t)buf);
    ct = (buf == 0xFF) ? 7 : 8;
    buf = 0;
  }

  void write_bit(int b) {
    buf = (buf << 1) | (b & 1);
    if (--ct == 0) emit();
  }

  void write_bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) write_bit((v >> i) & 1);
  }

  void write_commacode(int n) {
    for (int i = 0; i < n; i++) write_bit(1);
    write_bit(0);
  }

  void write_numpasses(int n) {
    if (n == 1) write_bit(0);
    else if (n == 2) write_bits(0b10, 2);
    else if (n <= 5) { write_bits(0b11, 2); write_bits(n - 3, 2); }
    else if (n <= 36) { write_bits(0b1111, 4); write_bits(n - 6, 5); }
    else { write_bits(0b111111111, 9); write_bits(n - 37, 7); }
  }

  void flush() {
    int full = (!out.empty() && out.back() == 0xFF) ? 7 : 8;
    if (ct < full) {
      buf <<= ct;
      out.push_back((uint8_t)(buf & 0xFF));
      buf = 0;
      ct = 8;
    }
    if (!out.empty() && out.back() == 0xFF) out.push_back(0x00);
  }
};

// ---------------------------------------------------------------------------
// Tag tree
// ---------------------------------------------------------------------------

struct TagTree {
  int w, h, nlev;
  std::vector<int> dims_w, dims_h, off;
  std::vector<int> value, low;
  std::vector<uint8_t> known;

  TagTree(int w_, int h_) : w(w_), h(h_) {
    int lw = w, lh = h, o = 0;
    for (;;) {
      dims_w.push_back(lw);
      dims_h.push_back(lh);
      off.push_back(o);
      o += lw * lh;
      if (lw == 1 && lh == 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    nlev = (int)dims_w.size();
    value.assign(o, T2_INF);
    low.assign(o, 0);
    known.assign(o, 0);
  }

  void set_value(int x, int y, int v) {
    for (int lev = 0; lev < nlev; lev++) {
      int idx = off[lev] + (y >> lev) * dims_w[lev] + (x >> lev);
      if (value[idx] > v) value[idx] = v; else break;
    }
  }

  void encode(BitWriter& bw, int x, int y, int threshold) {
    int lo = 0;
    for (int lev = nlev - 1; lev >= 0; lev--) {
      int idx = off[lev] + (y >> lev) * dims_w[lev] + (x >> lev);
      if (lo < low[idx]) lo = low[idx];
      while (lo < threshold) {
        if (lo >= value[idx]) {
          if (!known[idx]) {
            bw.write_bit(1);
            known[idx] = 1;
          }
          break;
        }
        bw.write_bit(0);
        lo += 1;
      }
      low[idx] = lo;
    }
  }
};

constexpr int CBLKSTY_LAZY = 0x01;
constexpr int CBLKSTY_TERMALL = 0x04;

static int seg_maxpasses(int seg_index, int style) {
  if (style & 0x40)  // HT: [cleanup][SigProp+MagRef] per HT set
    return (seg_index % 2 == 0) ? 1 : 2;
  if (style & CBLKSTY_TERMALL) return 1;
  if (style & CBLKSTY_LAZY) {
    if (seg_index == 0) return 10;
    return (seg_index % 2 == 1) ? 2 : 1;
  }
  return 109;
}

static inline int floorlog2(int n) {
  int r = -1;
  while (n) { r++; n >>= 1; }
  return r;
}

struct CblkState {
  int cx, cy, imsb, numpasses;
  int64_t data_off;
  const int32_t* rates;      // cumulative, per pass
  const uint8_t* term;       // per pass
  const int32_t* layer_np;   // per layer
  bool included = false;
  int lblock = 3;
  int passes_used = 0;

  int first_contrib_layer(int numlayers) const {
    for (int l = 0; l < numlayers; l++)
      if (layer_np[l] > 0) return l;
    return T2_INF;
  }

  int pass_bytes(int a, int b) const {
    if (b <= a) return 0;
    int lo = a > 0 ? rates[a - 1] : 0;
    return rates[b - 1] - lo;
  }
};

}  // namespace

// Encode all layers of one precinct group (shared by the real encoder
// and the tile-wide simulator; simulate=true skips body byte copies and
// only counts). Returns total bytes for layers 0..max_layer, or -1.
static int64_t encode_group(
    int numlayers, int max_layer, int eph, int nbands, const int32_t* grid,
    const int32_t* ncblks, const int64_t* cblk_meta,
    const int32_t* layer_npasses, const int32_t* pass_rates,
    const uint8_t* pass_term, int pass_stride, const uint8_t* data_flat,
    uint8_t* out, int64_t out_cap, int64_t* layer_off, bool simulate) {
  std::vector<TagTree> incl, imsbt;
  std::vector<std::vector<CblkState>> bands(nbands);
  int ci = 0;
  for (int b = 0; b < nbands; b++) {
    int gw = grid[b * 2] > 0 ? grid[b * 2] : 1;
    int gh = grid[b * 2 + 1] > 0 ? grid[b * 2 + 1] : 1;
    incl.emplace_back(gw, gh);
    imsbt.emplace_back(gw, gh);
    for (int k = 0; k < ncblks[b]; k++, ci++) {
      CblkState cs;
      cs.cx = (int)cblk_meta[ci * 5];
      cs.cy = (int)cblk_meta[ci * 5 + 1];
      cs.imsb = (int)cblk_meta[ci * 5 + 2];
      cs.numpasses = (int)cblk_meta[ci * 5 + 3];
      cs.data_off = cblk_meta[ci * 5 + 4];
      cs.rates = pass_rates + (size_t)ci * pass_stride;
      cs.term = pass_term + (size_t)ci * pass_stride;
      cs.layer_np = layer_npasses + (size_t)ci * numlayers;
      bands[b].push_back(cs);
    }
  }
  for (int b = 0; b < nbands; b++) {
    for (auto& cb : bands[b]) {
      int fl = cb.first_contrib_layer(numlayers);
      incl[b].set_value(cb.cx, cb.cy, fl);
      imsbt[b].set_value(cb.cx, cb.cy, cb.imsb);
    }
  }

  std::vector<uint8_t> frag;
  int64_t total = 0;
  for (int layer = 0; layer <= max_layer; layer++) {
    if (layer_off) layer_off[layer] = total;
    frag.clear();
    BitWriter bw(frag);
    bool nonempty = false;
    for (int b = 0; b < nbands; b++)
      for (auto& cb : bands[b])
        if (cb.layer_np[layer] > 0) nonempty = true;
    int64_t body_bytes = 0;
    std::vector<uint8_t> body;
    if (!nonempty) {
      bw.write_bit(0);
      bw.flush();
      if (eph) {
        frag.push_back(0xFF);
        frag.push_back(0x92);
      }
    } else {
      bw.write_bit(1);
      for (int b = 0; b < nbands; b++) {
        for (auto& cb : bands[b]) {
          int n = cb.layer_np[layer];
          if (!cb.included) {
            incl[b].encode(bw, cb.cx, cb.cy, layer + 1);
          } else {
            bw.write_bit(n > 0 ? 1 : 0);
          }
          if (n == 0) continue;
          if (!cb.included) {
            int t = 1;
            for (;;) {
              imsbt[b].encode(bw, cb.cx, cb.cy, t);
              if (cb.imsb < t) break;
              t += 1;
            }
            cb.included = true;
            cb.lblock = 3;
          }
          bw.write_numpasses(n);
          int segs_np[64], segs_nb[64], nsegs = 0;
          {
            int a = cb.passes_used, end = a + n, i = a;
            while (i < end) {
              int j = i;
              while (j < end - 1 && !cb.term[j]) j++;
              segs_np[nsegs] = j - i + 1;
              segs_nb[nsegs] = cb.pass_bytes(i, j + 1);
              nsegs++;
              i = j + 1;
            }
          }
          int increment = 0;
          for (int s2 = 0; s2 < nsegs; s2++) {
            int nb2 = segs_nb[s2];
            int bits_needed = 1;
            while ((1 << bits_needed) <= nb2) bits_needed++;
            if (nb2 == 0) bits_needed = 1;
            int have = cb.lblock + floorlog2(segs_np[s2]);
            if (bits_needed - have > increment)
              increment = bits_needed - have;
          }
          bw.write_commacode(increment);
          cb.lblock += increment;
          for (int s2 = 0; s2 < nsegs; s2++)
            bw.write_bits((uint32_t)segs_nb[s2],
                          cb.lblock + floorlog2(segs_np[s2]));
          int nbytes = 0;
          for (int s2 = 0; s2 < nsegs; s2++) nbytes += segs_nb[s2];
          if (!simulate) {
            int start =
                cb.passes_used > 0 ? cb.rates[cb.passes_used - 1] : 0;
            const uint8_t* src = data_flat + cb.data_off + start;
            body.insert(body.end(), src, src + nbytes);
          }
          body_bytes += nbytes;
          cb.passes_used += n;
        }
      }
      bw.flush();
      if (eph) {
        frag.push_back(0xFF);
        frag.push_back(0x92);
      }
      if (!simulate) frag.insert(frag.end(), body.begin(), body.end());
    }
    int64_t flen = (int64_t)frag.size() + (simulate ? body_bytes : 0);
    if (!simulate) {
      if (total + (int64_t)frag.size() > out_cap) return -1;
      std::memcpy(out + total, frag.data(), frag.size());
    }
    total += flen;
  }
  if (layer_off) layer_off[max_layer + 1] = total;
  return total;
}

extern "C" {

// Simulate the whole tile's packet emission: every precinct group's
// layers 0..max_layer are header-encoded (no body copies) in one native
// call; out_bytes[g] receives each group's byte total. All group data is
// concatenated: g_nbands gives each group's band count; grids/ncblks/
// cblk arrays follow in group order (PCRD bisection calls this once per
// iteration instead of once per group — the reference's
// encode_packets_simulate analog, T2.cpp:131).
int grok_t2_simulate_tile(
    int ngroups, int numlayers, int max_layer, int eph,
    const int32_t* g_nbands, const int32_t* grid, const int32_t* ncblks,
    const int64_t* cblk_meta, const int32_t* layer_npasses,
    const int32_t* pass_rates, const uint8_t* pass_term, int pass_stride,
    int64_t* out_bytes) {
  int band_off = 0, cblk_off = 0;
  for (int g = 0; g < ngroups; g++) {
    int nb = g_nbands[g];
    out_bytes[g] = encode_group(
        numlayers, max_layer, eph, nb, grid + (size_t)band_off * 2,
        ncblks + band_off, cblk_meta + (size_t)cblk_off * 5,
        layer_npasses + (size_t)cblk_off * numlayers,
        pass_rates + (size_t)cblk_off * pass_stride,
        pass_term + (size_t)cblk_off * pass_stride, pass_stride, nullptr,
        nullptr, 0, nullptr, true);
    for (int b = 0; b < nb; b++) cblk_off += ncblks[band_off + b];
    band_off += nb;
  }
  return 0;
}

// Whole-tile packet emission: every group encoded in one call, each
// into its own slot of `out` (slot prefix offsets in
// group_off, ngroups+1 entries). Per-(group, layer) fragment offsets are
// written to frag_off (ngroups x (numlayers+1), relative to the group
// slot). Returns -1 if any group overflows its slot.
int grok_t2_encode_tile(
    int ngroups, int numlayers, int max_layer, int eph,
    const int32_t* g_nbands, const int32_t* grid, const int32_t* ncblks,
    const int64_t* cblk_meta, const int32_t* layer_npasses,
    const int32_t* pass_rates, const uint8_t* pass_term, int pass_stride,
    const uint8_t* data_flat, uint8_t* out, const int64_t* group_off,
    int64_t* frag_off) {
  std::vector<int> band_offs(ngroups), cblk_offs(ngroups);
  int band_off = 0, cblk_off = 0;
  for (int g = 0; g < ngroups; g++) {
    band_offs[g] = band_off;
    cblk_offs[g] = cblk_off;
    int nb = g_nbands[g];
    for (int b = 0; b < nb; b++) cblk_off += ncblks[band_off + b];
    band_off += nb;
  }
  bool err = false;
  for (int g = 0; g < ngroups; g++) {
    int nb = g_nbands[g];
    int bo = band_offs[g], co = cblk_offs[g];
    int64_t cap = group_off[g + 1] - group_off[g];
    int64_t n = encode_group(
        numlayers, max_layer, eph, nb, grid + (size_t)bo * 2,
        ncblks + bo, cblk_meta + (size_t)co * 5,
        layer_npasses + (size_t)co * numlayers,
        pass_rates + (size_t)co * pass_stride,
        pass_term + (size_t)co * pass_stride, pass_stride, data_flat,
        out + group_off[g], cap, frag_off + (size_t)g * (numlayers + 1),
        false);
    if (n < 0 || n > cap) err = true;
  }
  return err ? -1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tier-2 packet PARSER: walks a tile's whole packet sequence natively.
// Mirror of the Python reader (codestream/t2.py decode_packet,
// bitio.py BitReader); per-code-block output is a segment list into the
// body buffer plus (numbps-driving) imsb and pass counts.
// ---------------------------------------------------------------------------

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t pos, start, size;
  int buf = 0, ct = 0;

  BitReader(const uint8_t* d, int64_t p, int64_t n)
      : data(d), pos(p), start(p), size(n) {}

  int read_bit() {
    if (ct == 0) {
      bool prev_ff = pos > start && pos - 1 < size && data[pos - 1] == 0xFF;
      buf = (pos < size) ? data[pos] : 0;
      pos++;
      ct = prev_ff ? 7 : 8;
    }
    ct--;
    return (buf >> ct) & 1;
  }

  uint32_t read_bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | read_bit();
    return v;
  }

  void align() {
    ct = 0;
    if (pos > start && pos <= size && data[pos - 1] == 0xFF) pos++;
  }

  int read_commacode() {
    int n = 0;
    while (read_bit()) n++;
    return n;
  }

  int read_numpasses() {
    if (!read_bit()) return 1;
    if (!read_bit()) return 2;
    int n = (int)read_bits(2);
    if (n != 3) return 3 + n;
    n = (int)read_bits(5);
    if (n != 31) return 6 + n;
    return 37 + (int)read_bits(7);
  }
};

// Tag-tree decoder (mirror of tagtree.py decode).
struct TagTreeDec {
  int w, h, nlev;
  std::vector<int> dims_w, dims_h, off;
  std::vector<int> value, low;

  TagTreeDec(int w_, int h_) : w(w_), h(h_) {
    int lw = w, lh = h, o = 0;
    for (;;) {
      dims_w.push_back(lw);
      dims_h.push_back(lh);
      off.push_back(o);
      o += lw * lh;
      if (lw == 1 && lh == 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    nlev = (int)dims_w.size();
    value.assign(o, T2_INF);
    low.assign(o, 0);
  }

  bool decode(BitReader& br, int x, int y, int threshold) {
    int lo = 0;
    int leaf = -1;
    for (int lev = nlev - 1; lev >= 0; lev--) {
      int idx = off[lev] + (y >> lev) * dims_w[lev] + (x >> lev);
      leaf = idx;
      if (lo < low[idx]) lo = low[idx];
      while (lo < threshold) {
        if (lo >= value[idx]) break;
        if (br.read_bit())
          value[idx] = lo;
        else
          lo += 1;
      }
      low[idx] = lo;
    }
    return value[leaf] < threshold;
  }
};

constexpr int T2D_MAX_SEGS = 64;
constexpr int T2D_MAX_CHUNKS = 160;

struct CblkDecState {
  int cx, cy, kmax;
  bool included = false;
  int lblock = 3;
  int numbps = 0, imsb = 0;
  int numpasses = 0;
  int nsegs = 0;
  int seg_np[T2D_MAX_SEGS];     // passes accumulated per segment
  int seg_max[T2D_MAX_SEGS];    // termination-rule capacity
  // Segment bytes arrive as per-packet chunks at non-contiguous body
  // offsets; record each chunk with its segment index.
  int nchunks = 0;
  int chunk_seg[T2D_MAX_CHUNKS];
  int chunk_np[T2D_MAX_CHUNKS];
  int64_t chunk_off[T2D_MAX_CHUNKS];
  int64_t chunk_len[T2D_MAX_CHUNKS];
};

static int dec_seg_maxpasses(int seg_index, int style) {
  if (style & 0x40)  // HT: [cleanup][SigProp+MagRef] per HT set
    return (seg_index % 2 == 0) ? 1 : 2;
  if (style & CBLKSTY_TERMALL) return 1;
  if (style & CBLKSTY_LAZY) {
    if (seg_index == 0) return 10;
    return (seg_index % 2 == 1) ? 2 : 1;
  }
  return 109;
}

struct PrecDecState {
  TagTreeDec incl, imsbt;
  std::vector<CblkDecState*> cblks;
  PrecDecState(int gw, int gh) : incl(gw, gh), imsbt(gw, gh) {}
};

}  // namespace

extern "C" {

// Parse all packets of one tile.
//   body/body_len: the tile's packet bytes
//   npackets, pkt_group[i], pkt_layer[i]: progression-ordered packet list;
//     pkt_group indexes the precinct group, pkt_layer the quality layer
//   ngroups; per group: gband_off[g]..gband_off[g+1] indexes into the
//     band-precinct arrays: grid dims (int32 x2), ncblks, kmax, style
//   per cblk (int64 x 3): cx, cy, (unused)
//   sop/eph flags
//   nlayers: the quality layers kept; a packet of a later layer is parsed
//     (its header updates the tag trees, Lblock and segment state) but its
//     passes and bytes are dropped, as the Python parser's
//     decode_packet(..., discard=True) does. A code-block's dropped layers
//     are a suffix of its packets, so what is kept stays consistent.
// Outputs per cblk: meta (int64 x 4): numbps, numpasses, nsegs, seg_base
//   (index into seg_out); seg_out (int64 x 3 per segment): offset, length,
//   numpasses.  Returns number of bytes consumed or -1 on error.
int64_t grok_t2_decode_tile(
    const uint8_t* body, int64_t body_len, int npackets,
    const int32_t* pkt_group, const int32_t* pkt_layer, int ngroups,
    const int32_t* gband_off, const int32_t* band_grid,
    const int32_t* band_ncblks, const int32_t* band_kmax,
    const int32_t* band_style, const int64_t* cblk_meta, int sop, int eph,
    int nlayers, int64_t* out_meta, int64_t* seg_out, int64_t seg_cap) {
  // Build precinct-group state.
  int total_cblks = 0;
  int total_bands = gband_off[ngroups];
  std::vector<int> band_cblk_base(total_bands);
  for (int b = 0; b < total_bands; b++) {
    band_cblk_base[b] = total_cblks;
    total_cblks += band_ncblks[b];
  }
  std::vector<CblkDecState> cblks(total_cblks);
  for (int i = 0; i < total_cblks; i++) {
    cblks[i].cx = (int)cblk_meta[i * 3];
    cblks[i].cy = (int)cblk_meta[i * 3 + 1];
  }
  std::vector<PrecDecState> bands;
  bands.reserve(total_bands);
  for (int b = 0; b < total_bands; b++) {
    bands.emplace_back(band_grid[b * 2] > 0 ? band_grid[b * 2] : 1,
                       band_grid[b * 2 + 1] > 0 ? band_grid[b * 2 + 1] : 1);
    for (int k = 0; k < band_ncblks[b]; k++) {
      CblkDecState* cs = &cblks[band_cblk_base[b] + k];
      cs->kmax = band_kmax[b];
      bands[b].cblks.push_back(cs);
    }
  }

  int64_t pos = 0;
  struct PendSeg { CblkDecState* cb; int seg_idx; };
  std::vector<PendSeg> pend;
  std::vector<int64_t> chunk_lens;
  for (int pi = 0; pi < npackets; pi++) {
    if (pos >= body_len) break;
    int g = pkt_group[pi];
    int layer = pkt_layer[pi];
    const bool keep = layer < nlayers;
    int b0 = gband_off[g], b1 = gband_off[g + 1];
    int style = band_style[b0];
    // optional SOP
    if (sop && pos + 6 <= body_len && body[pos] == 0xFF &&
        body[pos + 1] == 0x91)
      pos += 6;
    BitReader br(body, pos, body_len);
    pend.clear();
    if (!br.read_bit()) {
      br.align();
      pos = br.pos;
      if (eph && pos + 2 <= body_len && body[pos] == 0xFF &&
          body[pos + 1] == 0x92)
        pos += 2;
      continue;
    }
    bool bad = false;
    for (int b = b0; b < b1 && !bad; b++) {
      PrecDecState& pr = bands[b];
      for (auto* cb : pr.cblks) {
        bool inc;
        if (!cb->included) {
          inc = pr.incl.decode(br, cb->cx, cb->cy, layer + 1);
        } else {
          inc = br.read_bit() != 0;
        }
        if (!inc) continue;
        if (!cb->included) {
          int t = 1;
          while (!pr.imsbt.decode(br, cb->cx, cb->cy, t)) t++;
          cb->imsb = t - 1;
          cb->numbps = cb->kmax - cb->imsb;
          cb->included = true;
          cb->lblock = 3;
        }
        int n = br.read_numpasses();
        int increment = br.read_commacode();
        cb->lblock += increment;
        int remaining = n;
        while (remaining > 0) {
          int si;
          if (cb->nsegs > 0 &&
              cb->seg_np[cb->nsegs - 1] < cb->seg_max[cb->nsegs - 1]) {
            si = cb->nsegs - 1;
          } else {
            if (cb->nsegs >= T2D_MAX_SEGS) { bad = true; break; }
            si = cb->nsegs++;
            cb->seg_np[si] = 0;
            cb->seg_max[si] = dec_seg_maxpasses(si, style);
          }
          int take = remaining < cb->seg_max[si] - cb->seg_np[si]
                         ? remaining
                         : cb->seg_max[si] - cb->seg_np[si];
          int fl = 0;
          { int v = take; while (v > 1) { v >>= 1; fl++; } }
          int64_t ln = br.read_bits(cb->lblock + fl);
          if (keep) {
            if (cb->nchunks >= T2D_MAX_CHUNKS) { bad = true; break; }
            int ci2 = cb->nchunks++;
            cb->chunk_seg[ci2] = si;
            cb->chunk_np[ci2] = take;
            cb->chunk_len[ci2] = ln;
            pend.push_back({cb, ci2});
            cb->numpasses += take;
          } else {
            pend.push_back({nullptr, -1});   // bytes skipped, not kept
          }
          chunk_lens.push_back(ln);
          cb->seg_np[si] += take;
          remaining -= take;
        }
      }
    }
    if (bad) return -1;
    br.align();
    pos = br.pos;
    if (eph && pos + 2 <= body_len && body[pos] == 0xFF &&
        body[pos + 1] == 0x92)
      pos += 2;
    // body bytes in header order
    for (size_t k = 0; k < pend.size(); k++) {
      CblkDecState* cb = pend[k].cb;
      int ci2 = pend[k].seg_idx;  // chunk index
      if (cb) cb->chunk_off[ci2] = pos;
      pos += chunk_lens[k];
    }
    chunk_lens.clear();
  }

  // Emit outputs: per-cblk chunk lists (offset, length, segment index).
  int64_t base = 0;
  for (int i = 0; i < total_cblks; i++) {
    CblkDecState& cb = cblks[i];
    out_meta[i * 4] = cb.numbps;
    out_meta[i * 4 + 1] = cb.numpasses;
    out_meta[i * 4 + 2] = cb.nchunks;
    out_meta[i * 4 + 3] = base;
    for (int k = 0; k < cb.nchunks; k++) {
      if (base + 1 > seg_cap) return -1;
      seg_out[base * 3] = cb.chunk_off[k];
      seg_out[base * 3 + 1] = cb.chunk_len[k];
      seg_out[base * 3 + 2] = cb.chunk_seg[k];
      base++;
    }
  }
  return pos;
}

}  // extern "C"
