/* JPEG entropy decoding and pixel reconstruction, in plain C, bit-exact with
 * libjpeg-turbo's default decode (what OpenCV's imread and Pillow return).
 *
 * Used by sixdof_tpu_torch/io/jpeg.py, which parses the markers and hands
 * each scan's entropy-coded segment here.  Host code, no CUDA: built with
 * the system C compiler at first use (kernels/build.py) and called with
 * ctypes.
 *
 * jpeg_scan: Huffman-decodes one scan (sequential, or a progressive DC/AC
 * first or refinement scan) into the components' coefficient buffers.
 * jpeg_pixels: dequantises and inverse-transforms every component (the
 * "islow" integer IDCT of jidctint.c), upsamples it to the image size
 * (jdsample.c's "fancy" triangle filter for 2:1 ratios, replication for
 * the others) and converts the colours (jdcolor.c's fixed-point YCbCr
 * tables) into interleaved 8-bit RGB or BGR.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* zigzag index -> natural (row-major) index, padded so that a corrupt run
 * past coefficient 63 stays inside the block (as jutils.c pads it) */
static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { ERR_BAD_TABLE = 1, ERR_NO_MEMORY = 2 };

/* ---------------------------------------------------------------- bits -- */

typedef struct {
  const uint8_t *p, *end;
  uint64_t acc;   /* bits left-aligned: the next bit is bit 63 */
  int nbits;
  int marker;     /* 1 once a marker stops the data: zeros are fed after it */
} BitReader;

static void fill(BitReader* br) {
  while (br->nbits <= 56) {
    unsigned c = 0;
    if (!br->marker && br->p < br->end) {
      c = *br->p++;
      if (c == 0xFF) {
        /* FF 00 is an FF data byte (any FFs before the 00 too, as libjpeg
         * accepts); FF then anything else is a marker, left unread */
        const uint8_t* q = br->p;
        while (q < br->end && *q == 0xFF) ++q;
        if (q < br->end && *q == 0) {
          br->p = q + 1;
        } else {
          br->p -= 1;
          br->marker = 1;
          c = 0;
        }
      }
    }
    br->acc |= (uint64_t)c << (56 - br->nbits);
    br->nbits += 8;
  }
}

static inline unsigned peek(BitReader* br, int n) {
  if (br->nbits < n) fill(br);
  return (unsigned)(br->acc >> (64 - n));
}

static inline void skip(BitReader* br, int n) {
  br->acc <<= n;
  br->nbits -= n;
}

static inline unsigned get_bits(BitReader* br, int n) {
  if (n == 0) return 0;
  unsigned v = peek(br, n);
  skip(br, n);
  return v;
}

/* the value of an @s-bit magnitude category (HUFF_EXTEND) */
static inline int extend(unsigned v, int s) {
  return (s && v < (1u << (s - 1))) ? (int)v + (int)(((unsigned)-1) << s) + 1 : (int)v;
}

/* skip to the next restart marker and past it; bits still buffered are
 * dropped */
static void restart(BitReader* br) {
  br->acc = 0;
  br->nbits = 0;
  br->marker = 0;
  while (br->p + 1 < br->end) {
    if (br->p[0] == 0xFF && br->p[1] != 0 && br->p[1] != 0xFF) {
      if (br->p[1] >= 0xD0 && br->p[1] <= 0xD7) br->p += 2;
      return;
    }
    ++br->p;
  }
  br->p = br->end;
}

/* ------------------------------------------------------------- huffman -- */

#define LOOK 9

typedef struct {
  int32_t maxcode[18];   /* largest code of each length, -1 if none */
  int32_t valoffset[18]; /* huffval index = code + valoffset[length] */
  uint8_t val[256];
  uint16_t look[1 << LOOK]; /* length << 8 | symbol for short codes, 0 if longer */
} Huffman;

/* @spec: bits[16] (codes of each length 1..16) then up to 256 symbols; a
 * DC table's symbols (magnitude categories) are at most 15 */
static int build_huffman(Huffman* h, const uint8_t* spec, int dc) {
  const uint8_t* bits = spec;
  int n = 0;
  for (int l = 0; l < 16; ++l) n += bits[l];
  if (n > 256) return ERR_BAD_TABLE;
  memcpy(h->val, spec + 16, (size_t)n);
  for (int i = 0; dc && i < n; ++i)
    if (h->val[i] > 15) return ERR_BAD_TABLE;
  memset(h->look, 0, sizeof(h->look));
  int code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      h->valoffset[l] = p - code;
      /* the codes must fit in l bits, and none may be all ones (as libjpeg checks) */
      if (code + bits[l - 1] >= (1 << l)) return ERR_BAD_TABLE;
      for (int i = 0; i < bits[l - 1]; ++i, ++p, ++code) {
        if (l <= LOOK) {
          const int shift = LOOK - l;
          for (int j = 0; j < (1 << shift); ++j)
            h->look[(code << shift) | j] = (uint16_t)(l << 8 | h->val[p]);
        }
      }
      h->maxcode[l] = code - 1;
    } else {
      h->maxcode[l] = -1;
    }
    code <<= 1;
  }
  h->maxcode[17] = 0x7FFFFFFF;
  return 0;
}

static int decode_symbol(BitReader* br, const Huffman* h) {
  const unsigned look = h->look[peek(br, LOOK)];
  if (look) {
    skip(br, look >> 8);
    return look & 0xFF;
  }
  const unsigned bits16 = peek(br, 16);
  int l = LOOK + 1;
  while (l <= 16 && (int32_t)(bits16 >> (16 - l)) > h->maxcode[l]) ++l;
  if (l > 16) { /* a code no table holds: corrupt data, libjpeg gives 0 */
    skip(br, 16);
    return 0;
  }
  skip(br, l);
  return h->val[((int)(bits16 >> (16 - l)) + h->valoffset[l]) & 0xFF];
}

/* ---------------------------------------------------------------- scan -- */

typedef struct {
  BitReader br;
  int eobrun;
  int dc_pred[4];
} ScanState;

static void block_sequential(ScanState* s, int16_t* blk, int c, const Huffman* dc,
                             const Huffman* ac) {
  int t = decode_symbol(&s->br, dc);
  int diff = t ? extend(get_bits(&s->br, t), t) : 0;
  s->dc_pred[c] += diff;
  blk[0] = (int16_t)s->dc_pred[c];
  for (int k = 1; k < 64; ++k) {
    const int rs = decode_symbol(&s->br, ac);
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend(get_bits(&s->br, sz), sz);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

static void block_dc_first(ScanState* s, int16_t* blk, int c, const Huffman* dc, int al) {
  int t = decode_symbol(&s->br, dc);
  int diff = t ? extend(get_bits(&s->br, t), t) : 0;
  s->dc_pred[c] += diff;
  blk[0] = (int16_t)((unsigned)s->dc_pred[c] << al);
}

static void block_dc_refine(ScanState* s, int16_t* blk, int al) {
  if (get_bits(&s->br, 1)) blk[0] |= (int16_t)(1 << al);
}

static void block_ac_first(ScanState* s, int16_t* blk, const Huffman* ac, int ss, int se,
                           int al) {
  if (s->eobrun > 0) {
    s->eobrun--;
    return;
  }
  for (int k = ss; k <= se; ++k) {
    const int rs = decode_symbol(&s->br, ac);
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      k += r;
      blk[kNatural[k]] = (int16_t)((unsigned)extend(get_bits(&s->br, sz), sz) << al);
    } else if (r == 15) {
      k += 15;
    } else {
      s->eobrun = 1 << r;
      if (r) s->eobrun += (int)get_bits(&s->br, r);
      s->eobrun--;
      break;
    }
  }
}

/* jdphuff.c's decode_mcu_AC_refine: new coefficients of magnitude 1 << al,
 * and a correction bit for each coefficient already nonzero */
static void block_ac_refine(ScanState* s, int16_t* blk, const Huffman* ac, int ss, int se,
                            int al) {
  const int p1 = 1 << al, m1 = -(1 << al);
  int k = ss;
  if (s->eobrun == 0) {
    for (; k <= se; ++k) {
      const int rs = decode_symbol(&s->br, ac);
      int r = rs >> 4, v = rs & 15;
      if (v) {
        v = get_bits(&s->br, 1) ? p1 : m1;
      } else if (r != 15) {
        s->eobrun = 1 << r;
        if (r) s->eobrun += (int)get_bits(&s->br, r);
        break;
      }
      do {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (get_bits(&s->br, 1) && (*coef & p1) == 0)
            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (v) blk[kNatural[k]] = (int16_t)v;
    }
  }
  if (s->eobrun > 0) {
    for (; k <= se; ++k) {
      int16_t* coef = blk + kNatural[k];
      if (*coef != 0 && get_bits(&s->br, 1) && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    s->eobrun--;
  }
}

/* Decode one scan.
 * @data, @len: the entropy-coded segment, restart markers included;
 * @n: components in the scan; @coef[i]: component i's coefficient buffer,
 * @stride[i] blocks a row of 64 int16 each, natural order; @h, @v: their
 * sampling factors in an interleaved scan (n > 1), ignored otherwise;
 * @mcux, @mcuy: MCUs across and down (for n == 1, the component's blocks);
 * @tables: n * 2 table specs (DC then AC) of 16 + 256 bytes each;
 * @ss, @se, @ah, @al: the spectral band and successive approximation
 * (0, 63, 0, 0 for a sequential scan); @progressive; @restart_interval in
 * MCUs, 0 for none.  Returns 0, or ERR_BAD_TABLE. */
int jpeg_scan(const uint8_t* data, int len, int n, int16_t** coef, const int* stride,
              const int* h, const int* v, int mcux, int mcuy, const uint8_t* tables, int ss,
              int se, int ah, int al, int progressive, int restart_interval) {
  Huffman* huff = (Huffman*)malloc(sizeof(Huffman) * 2 * (size_t)n);
  if (!huff) return ERR_NO_MEMORY;
  const int need_dc = !progressive || (ss == 0 && ah == 0);
  const int need_ac = !progressive || ss > 0;
  for (int i = 0; i < n; ++i) {
    if ((need_dc && build_huffman(&huff[2 * i], tables + (2 * i) * 272, 1)) ||
        (need_ac && build_huffman(&huff[2 * i + 1], tables + (2 * i + 1) * 272, 0))) {
      free(huff);
      return ERR_BAD_TABLE;
    }
  }
  ScanState s;
  memset(&s, 0, sizeof(s));
  s.br.p = data;
  s.br.end = data + len;
  long mcu = 0;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx, ++mcu) {
      if (restart_interval && mcu && mcu % restart_interval == 0) {
        restart(&s.br);
        s.eobrun = 0;
        memset(s.dc_pred, 0, sizeof(s.dc_pred));
      }
      for (int i = 0; i < n; ++i) {
        const int bh = n > 1 ? h[i] : 1, bv = n > 1 ? v[i] : 1;
        for (int by = 0; by < bv; ++by) {
          for (int bx = 0; bx < bh; ++bx) {
            int16_t* blk = coef[i] + ((size_t)(my * bv + by) * stride[i] + mx * bh + bx) * 64;
            const Huffman* dc = &huff[2 * i];
            const Huffman* ac = &huff[2 * i + 1];
            if (!progressive) {
              block_sequential(&s, blk, i, dc, ac);
            } else if (ss == 0) {
              if (ah == 0)
                block_dc_first(&s, blk, i, dc, al);
              else
                block_dc_refine(&s, blk, al);
            } else if (ah == 0) {
              block_ac_first(&s, blk, ac, ss, se, al);
            } else {
              block_ac_refine(&s, blk, ac, ss, se, al);
            }
          }
        }
      }
    }
  }
  free(huff);
  return 0;
}

/* ---------------------------------------------------------------- IDCT -- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* jdmaster.c's post-IDCT range limit: a sample (centred on 0) masked to 10
 * bits, then clamped to 0..255 with the centre added */
static uint8_t kRange[1024];

static void init_range(void) {
  for (int i = 0; i < 1024; ++i) {
    const int x = i < 512 ? i : i - 1024;
    const int y = x + 128;
    kRange[i] = (uint8_t)(y < 0 ? 0 : y > 255 ? 255 : y);
  }
}

/* jidctint.c's jpeg_idct_islow: the odd and even parts of one 1-D pass */
#define IDCT_1D(in0, in1, in2, in3, in4, in5, in6, in7)                    \
  int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, \
      tmp13;                                                               \
  z2 = (in2);                                                              \
  z3 = (in6);                                                              \
  z1 = (z2 + z3) * FIX_0_541196100;                                        \
  tmp2 = z1 + z3 * -FIX_1_847759065;                                       \
  tmp3 = z1 + z2 * FIX_0_765366865;                                        \
  z2 = (in0);                                                              \
  z3 = (in4);                                                              \
  tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);                           \
  tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);                           \
  tmp10 = tmp0 + tmp3;                                                     \
  tmp13 = tmp0 - tmp3;                                                     \
  tmp11 = tmp1 + tmp2;                                                     \
  tmp12 = tmp1 - tmp2;                                                     \
  tmp0 = (in7);                                                            \
  tmp1 = (in5);                                                            \
  tmp2 = (in3);                                                            \
  tmp3 = (in1);                                                            \
  z1 = tmp0 + tmp3;                                                        \
  z2 = tmp1 + tmp2;                                                        \
  z3 = tmp0 + tmp2;                                                        \
  z4 = tmp1 + tmp3;                                                        \
  z5 = (z3 + z4) * FIX_1_175875602;                                        \
  tmp0 = tmp0 * FIX_0_298631336;                                           \
  tmp1 = tmp1 * FIX_2_053119869;                                           \
  tmp2 = tmp2 * FIX_3_072711026;                                           \
  tmp3 = tmp3 * FIX_1_501321110;                                           \
  z1 = z1 * -FIX_0_899976223;                                              \
  z2 = z2 * -FIX_2_562915447;                                              \
  z3 = z3 * -FIX_1_961570560;                                              \
  z4 = z4 * -FIX_0_390180644;                                              \
  z3 += z5;                                                                \
  z4 += z5;                                                                \
  tmp0 += z1 + z3;                                                         \
  tmp1 += z2 + z4;                                                         \
  tmp2 += z2 + z3;                                                         \
  tmp3 += z1 + z4;

static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int out_stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* col = in + c;
    const uint16_t* qc = q + c;
    if (!col[8] && !col[16] && !col[24] && !col[32] && !col[40] && !col[48] && !col[56]) {
      const int dc = (int)((unsigned)(col[0] * qc[0]) << PASS1_BITS);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    IDCT_1D((int64_t)col[0] * qc[0], (int64_t)col[8] * qc[8], (int64_t)col[16] * qc[16],
            (int64_t)col[24] * qc[24], (int64_t)col[32] * qc[32], (int64_t)col[40] * qc[40],
            (int64_t)col[48] * qc[48], (int64_t)col[56] * qc[56])
    const int sh = CONST_BITS - PASS1_BITS;
    ws[0 * 8 + c] = (int)DESCALE(tmp10 + tmp3, sh);
    ws[7 * 8 + c] = (int)DESCALE(tmp10 - tmp3, sh);
    ws[1 * 8 + c] = (int)DESCALE(tmp11 + tmp2, sh);
    ws[6 * 8 + c] = (int)DESCALE(tmp11 - tmp2, sh);
    ws[2 * 8 + c] = (int)DESCALE(tmp12 + tmp1, sh);
    ws[5 * 8 + c] = (int)DESCALE(tmp12 - tmp1, sh);
    ws[3 * 8 + c] = (int)DESCALE(tmp13 + tmp0, sh);
    ws[4 * 8 + c] = (int)DESCALE(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + (size_t)r * out_stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t dc = kRange[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) & 1023];
      memset(o, dc, 8);
      continue;
    }
    IDCT_1D(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7])
    o[0] = kRange[(int)DESCALE(tmp10 + tmp3, sh) & 1023];
    o[7] = kRange[(int)DESCALE(tmp10 - tmp3, sh) & 1023];
    o[1] = kRange[(int)DESCALE(tmp11 + tmp2, sh) & 1023];
    o[6] = kRange[(int)DESCALE(tmp11 - tmp2, sh) & 1023];
    o[2] = kRange[(int)DESCALE(tmp12 + tmp1, sh) & 1023];
    o[5] = kRange[(int)DESCALE(tmp12 - tmp1, sh) & 1023];
    o[3] = kRange[(int)DESCALE(tmp13 + tmp0, sh) & 1023];
    o[4] = kRange[(int)DESCALE(tmp13 - tmp0, sh) & 1023];
  }
}

/* ------------------------------------------------------------ upsample -- */

static inline int clampi(int x, int lo, int hi) { return x < lo ? lo : x > hi ? hi : x; }

/* One component plane @in (@cw x @ch samples, row stride @is) to the image
 * size @W x @H in @out (row stride W), by the factors @hx, @vx. */
static void upsample(const uint8_t* in, int is, int cw, int ch, int hx, int vx, uint8_t* out,
                     int W, int H) {
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; ++y) memcpy(out + (size_t)y * W, in + (size_t)y * is, (size_t)W);
  } else if (hx == 2 && vx == 1 && cw > 2) { /* h2v1_fancy_upsample */
    for (int y = 0; y < H; ++y) {
      const uint8_t* r = in + (size_t)y * is;
      uint8_t* o = out + (size_t)y * W;
      for (int x = 0; x < W; ++x) {
        const int i = x >> 1;
        o[x] = (x & 1) ? (uint8_t)((r[i] * 3 + r[i + 1 < cw ? i + 1 : i] + 2) >> 2)
                       : (uint8_t)((r[i] * 3 + r[i > 0 ? i - 1 : 0] + 1) >> 2);
      }
    }
  } else if (hx == 1 && vx == 2) { /* h1v2_fancy_upsample */
    for (int y = 0; y < H; ++y) {
      const int i = y >> 1;
      const uint8_t* near = in + (size_t)i * is;
      const uint8_t* far = in + (size_t)clampi(y & 1 ? i + 1 : i - 1, 0, ch - 1) * is;
      const int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + (size_t)y * W;
      for (int x = 0; x < W; ++x) o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    }
  } else if (hx == 2 && vx == 2 && cw > 2) { /* h2v2_fancy_upsample */
    int* sums = (int*)malloc(sizeof(int) * (size_t)cw);
    for (int y = 0; y < H; ++y) {
      const int i = y >> 1;
      const uint8_t* near = in + (size_t)i * is;
      const uint8_t* far = in + (size_t)clampi(y & 1 ? i + 1 : i - 1, 0, ch - 1) * is;
      for (int c = 0; c < cw; ++c) sums[c] = near[c] * 3 + far[c];
      uint8_t* o = out + (size_t)y * W;
      for (int x = 0; x < W; ++x) {
        const int c = x >> 1;
        o[x] = (x & 1) ? (uint8_t)((sums[c] * 3 + sums[c + 1 < cw ? c + 1 : c] + 7) >> 4)
                       : (uint8_t)((sums[c] * 3 + sums[c > 0 ? c - 1 : 0] + 8) >> 4);
      }
    }
    free(sums);
  } else { /* int_upsample, h2v1_upsample, h2v2_upsample: replication */
    for (int y = 0; y < H; ++y) {
      const uint8_t* r = in + (size_t)(y / vx) * is;
      uint8_t* o = out + (size_t)y * W;
      for (int x = 0; x < W; ++x) o[x] = r[x / hx];
    }
  }
}

/* -------------------------------------------------------------- pixels -- */

/* Reconstruct the image into @out (H x W x 3 bytes).
 * @n: 1 or 3 components; @coef[i], @stride[i]: as for jpeg_scan; @qt: n
 * quantisation tables of 64 values, natural order; @cw, @ch: each
 * component's size in samples (the image size scaled by its sampling
 * factor, rounded up); @hx, @vx: the image-to-component ratios;
 * @color: 0 grey (replicated), 1 YCbCr, 2 RGB stored as is; @bgr: write
 * BGR instead of RGB.  Returns 0, or ERR_NO_MEMORY. */
int jpeg_pixels(int n, int16_t** coef, const int* stride, const uint16_t* qt, const int* cw,
                const int* ch, const int* hx, const int* vx, int W, int H, int color, int bgr,
                uint8_t* out) {
  static int ready = 0;
  if (!ready) {
    init_range();
    ready = 1;
  }
  uint8_t* planes[3] = {NULL, NULL, NULL};
  uint8_t* comp = NULL;
  int rc = 0;
  for (int i = 0; i < n; ++i) {
    const int bw = (cw[i] + 7) / 8, bh = (ch[i] + 7) / 8, is = bw * 8;
    free(comp);
    comp = (uint8_t*)malloc((size_t)is * bh * 8);
    planes[i] = (uint8_t*)malloc((size_t)W * H);
    if (!comp || !planes[i]) {
      rc = ERR_NO_MEMORY;
      goto done;
    }
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx)
        idct_islow(coef[i] + ((size_t)by * stride[i] + bx) * 64, qt + i * 64,
                   comp + (size_t)by * 8 * is + bx * 8, is);
    upsample(comp, is, cw[i], ch[i], hx[i], vx[i], planes[i], W, H);
  }
  const size_t npix = (size_t)W * H;
  const int r_at = bgr ? 2 : 0, b_at = bgr ? 0 : 2;
  if (color == 0) {
    for (size_t p = 0; p < npix; ++p) out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = planes[0][p];
  } else if (color == 2) {
    for (size_t p = 0; p < npix; ++p) {
      out[3 * p + r_at] = planes[0][p];
      out[3 * p + 1] = planes[1][p];
      out[3 * p + b_at] = planes[2][p];
    }
  } else { /* jdcolor.c's ycc_rgb_convert, SCALEBITS 16 */
    int crr[256], cbb[256], crg[256], cbg[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      crr[i] = (int)(((int64_t)91881 * x + 32768) >> 16);  /* FIX(1.40200) */
      cbb[i] = (int)(((int64_t)116130 * x + 32768) >> 16); /* FIX(1.77200) */
      crg[i] = -46802 * x;                                 /* -FIX(0.71414) */
      cbg[i] = -22554 * x + 32768;                         /* -FIX(0.34414), ONE_HALF */
    }
    for (size_t p = 0; p < npix; ++p) {
      const int y = planes[0][p], cb = planes[1][p], cr = planes[2][p];
      out[3 * p + r_at] = (uint8_t)clampi(y + crr[cr], 0, 255);
      out[3 * p + 1] = (uint8_t)clampi(y + ((cbg[cb] + crg[cr]) >> 16), 0, 255);
      out[3 * p + b_at] = (uint8_t)clampi(y + cbb[cb], 0, 255);
    }
  }
done:
  free(comp);
  for (int i = 0; i < 3; ++i) free(planes[i]);
  return rc;
}
