/* PNG row-filter reversal (PNG specification, section 9), in plain C.
 *
 * Used by sixdof_tpu_torch/io/png.py, which inflates the image data with
 * zlib and hands the raw scanlines here.  Host code, no CUDA: built with the
 * system C compiler at first use (kernels/build.py) and called with ctypes.
 *
 * @raw: h rows of 1 + stride bytes, each a filter-type byte then the filtered
 * row; @out: h * stride bytes, the reconstructed rows; @bpp: bytes per
 * complete pixel (at least 1).  Returns 0, or 1 + the index of the first row
 * whose filter type is not 0-4 (rows before it are reconstructed).
 */
#include <stdint.h>
#include <stdlib.h>

int png_unfilter(const uint8_t* raw, uint8_t* out, int h, int stride, int bpp) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* f = raw + (size_t)y * (stride + 1);
    const uint8_t* cur = f + 1;
    uint8_t* rec = out + (size_t)y * stride;
    const uint8_t* prev = y ? rec - stride : NULL; /* NULL: the row above is zeros */
    switch (f[0]) {
      case 0: /* None */
        for (int x = 0; x < stride; ++x) rec[x] = cur[x];
        break;
      case 1: /* Sub */
        for (int x = 0; x < stride; ++x) rec[x] = (uint8_t)(cur[x] + (x >= bpp ? rec[x - bpp] : 0));
        break;
      case 2: /* Up */
        for (int x = 0; x < stride; ++x) rec[x] = (uint8_t)(cur[x] + (prev ? prev[x] : 0));
        break;
      case 3: /* Average */
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? rec[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          rec[x] = (uint8_t)(cur[x] + ((a + b) >> 1));
        }
        break;
      case 4: /* Paeth */
        for (int x = 0; x < stride; ++x) {
          const int a = x >= bpp ? rec[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          rec[x] = (uint8_t)(cur[x] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
