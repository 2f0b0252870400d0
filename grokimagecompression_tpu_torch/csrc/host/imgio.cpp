// PNG scanline unfiltering and filtering (spec: PNG 1.2 §6) of the
// port's host library, used by io/png.py through native/imgio.py.
// A copy of grokimagecompression_tpu/native/src/imgio.cpp. Average and
// Paeth need the reconstructed left neighbour, a serial scan; the port
// has no numpy fallback: a library that fails to build or load raises.

#include <cstdint>
#include <cstring>

extern "C" {

// In-place unfilter. `rows`: nrows scanlines, each 1 filter byte +
// rowbytes data, packed contiguously (stride = rowbytes + 1).
// Output: `out` nrows * rowbytes reconstructed bytes. bpp = bytes per
// complete pixel (filter distance). Returns 0, or -1 on a bad filter id.
int grok_png_unfilter(const uint8_t* rows, int nrows, int rowbytes, int bpp,
                      uint8_t* out) {
  for (int y = 0; y < nrows; y++) {
    const uint8_t* src = rows + (size_t)y * (rowbytes + 1);
    uint8_t filter = src[0];
    src++;
    uint8_t* cur = out + (size_t)y * rowbytes;
    const uint8_t* up = y > 0 ? cur - rowbytes : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(cur, src, rowbytes);
        break;
      case 1:  // Sub
        for (int x = 0; x < bpp && x < rowbytes; x++) cur[x] = src[x];
        for (int x = bpp; x < rowbytes; x++)
          cur[x] = (uint8_t)(src[x] + cur[x - bpp]);
        break;
      case 2:  // Up
        if (up) {
          for (int x = 0; x < rowbytes; x++)
            cur[x] = (uint8_t)(src[x] + up[x]);
        } else {
          std::memcpy(cur, src, rowbytes);
        }
        break;
      case 3:  // Average
        for (int x = 0; x < rowbytes; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          cur[x] = (uint8_t)(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int x = 0; x < rowbytes; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = (uint8_t)(src[x] + pred);
        }
        break;
      default:
        return -1;
    }
  }
  return 0;
}

// Filter scanlines for writing (single filter id for all rows; id 0-4).
// `img`: nrows * rowbytes; `out`: nrows * (rowbytes+1) with filter bytes.
int grok_png_filter(const uint8_t* img, int nrows, int rowbytes, int bpp,
                    int filter, uint8_t* out) {
  if (filter < 0 || filter > 4) return -1;
  for (int y = 0; y < nrows; y++) {
    const uint8_t* cur = img + (size_t)y * rowbytes;
    const uint8_t* up = y > 0 ? cur - rowbytes : nullptr;
    uint8_t* dst = out + (size_t)y * (rowbytes + 1);
    dst[0] = (uint8_t)filter;
    dst++;
    switch (filter) {
      case 0:
        std::memcpy(dst, cur, rowbytes);
        break;
      case 1:
        for (int x = 0; x < rowbytes; x++)
          dst[x] = (uint8_t)(cur[x] - (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int x = 0; x < rowbytes; x++)
          dst[x] = (uint8_t)(cur[x] - (up ? up[x] : 0));
        break;
      case 3:
        for (int x = 0; x < rowbytes; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          dst[x] = (uint8_t)(cur[x] - ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < rowbytes; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          int p = a + b - c;
          int pa = p > a ? p - a : a - p;
          int pb = p > b ? p - b : b - p;
          int pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[x] = (uint8_t)(cur[x] - pred);
        }
        break;
    }
  }
  return 0;
}

}  // extern "C"
