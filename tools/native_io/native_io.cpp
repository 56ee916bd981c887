// native_io — host-side I/O runtime for dis_tpu (C++, ctypes ABI).
//
// The reference's runtime is native C++ (OpenCV imread/imwrite, .flo
// codec, color-wheel rasterization); this library provides the same
// host-side services for the JAX build without an OpenCV dependency:
//   - PNG decode (zlib inflate + unfilter) to 8-bit gray with
//     OpenCV-exact BT.601 fixed-point conversion (cf. main.cpp:115)
//   - Middlebury .flo encode/decode (cf. IO_flow.cpp:10-98)
//   - Middlebury color-wheel flow rasterization (cf. color_coding.cpp)
// Exposed with a plain C ABI for ctypes; Python falls back to pure
// NumPy implementations when the library is absent.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG decode (8/16-bit gray or 8-bit RGB/RGBA, non-interlaced)
// ---------------------------------------------------------------------------

static uint32_t rd_u32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static inline uint8_t bt601_gray(int r, int g, int b) {
  return (uint8_t)((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode a PNG byte buffer to 8-bit grayscale. Returns 0 on success.
// On success *out_w/*out_h are set and out (caller buffer of capacity
// cap bytes) holds row-major gray pixels.
int png_decode_gray(const uint8_t* buf, long n, uint8_t* out, long cap,
                    int* out_w, int* out_h) {
  if (n < 8 || memcmp(buf, "\x89PNG\r\n\x1a\n", 8) != 0) return -1;
  long off = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (off + 8 <= n) {
    uint32_t len = rd_u32(buf + off);
    const uint8_t* type = buf + off + 4;
    const uint8_t* data = buf + off + 8;
    if (off + 12 + (long)len > n) return -2;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -3;
      w = (int)rd_u32(data);
      h = (int)rd_u32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
      if (interlace != 0) return -4;  // Adam7 unsupported
      if (bit_depth != 8 && bit_depth != 16) return -5;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (w <= 0 || h <= 0 || idat.empty()) return -6;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return -7;           // palette unsupported
  }
  const int bpp = channels * (bit_depth / 8);
  const long stride = (long)w * bpp;
  std::vector<uint8_t> raw((stride + 1) * (size_t)h);
  uLongf raw_len = (uLongf)raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), (uLong)idat.size()) != Z_OK
      || raw_len != raw.size())
    return -8;
  if ((long)w * h > cap) return -9;

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = raw.data() + (size_t)y * (stride + 1);
    const int f = row[0];
    const uint8_t* src = row + 1;
    for (long x = 0; x < stride; ++x) {
      int a = x >= bpp ? cur[x - bpp] : 0;
      int b = prev[x];
      int c = x >= bpp ? prev[x - bpp] : 0;
      int v = src[x];
      switch (f) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -10;
      }
      cur[x] = (uint8_t)v;
    }
    uint8_t* dst = out + (size_t)y * w;
    const int step = bit_depth / 8;
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = cur.data() + (size_t)x * bpp;
      // 16-bit: take the high byte (PIL/OpenCV 8-bit convert behavior)
      int c0 = px[0];
      if (channels == 1 || channels == 2) {
        dst[x] = (uint8_t)c0;
      } else {
        int r = px[0], g = px[step], b2 = px[2 * step];
        dst[x] = bt601_gray(r, g, b2);
      }
    }
    prev.swap(cur);
  }
  *out_w = w;
  *out_h = h;
  return 0;
}

// ---------------------------------------------------------------------------
// KITTI flow-GT codec: 16-bit RGB PNG, (u,v)*64 + 2^15 + validity
// channel (devkit flow_read.m / flow_write.m).  The Sintel-side GT is
// the .flo codec below; together they cover both benchmarks' formats.
// ---------------------------------------------------------------------------

// Decode a 16-bit RGB PNG file into flow [h*w*2] f32 + valid [h*w] u8.
// flow_cap / valid_cap are element capacities.  Returns 0 on success.
int kitti_flow_read(const char* path, float* flow, long flow_cap,
                    uint8_t* valid, long valid_cap, int* out_w,
                    int* out_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)n);
  if (fread(buf.data(), 1, (size_t)n, f) != (size_t)n) { fclose(f); return -1; }
  fclose(f);
  if (n < 8 || memcmp(buf.data(), "\x89PNG\r\n\x1a\n", 8) != 0) return -2;
  long off = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0;
  std::vector<uint8_t> idat;
  while (off + 8 <= n) {
    uint32_t len = rd_u32(buf.data() + off);
    const uint8_t* type = buf.data() + off + 4;
    const uint8_t* data = buf.data() + off + 8;
    if (off + 12 + (long)len > n) return -3;
    if (memcmp(type, "IHDR", 4) == 0) {
      w = (int)rd_u32(data);
      h = (int)rd_u32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      if (data[12] != 0) return -4;  // interlaced
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (w <= 0 || h <= 0 || idat.empty()) return -5;
  if (bit_depth != 16 || color_type != 2) return -6;  // must be 16-bit RGB
  const int bpp = 6;
  const long stride = (long)w * bpp;
  std::vector<uint8_t> raw((stride + 1) * (size_t)h);
  uLongf raw_len = (uLongf)raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), (uLong)idat.size()) != Z_OK
      || raw_len != raw.size())
    return -7;
  if ((long)w * h * 2 > flow_cap || (long)w * h > valid_cap) return -8;

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = raw.data() + (size_t)y * (stride + 1);
    const int ft = row[0];
    const uint8_t* src = row + 1;
    for (long x = 0; x < stride; ++x) {
      int a = x >= bpp ? cur[x - bpp] : 0;
      int b = prev[x];
      int c = x >= bpp ? prev[x - bpp] : 0;
      int v = src[x];
      switch (ft) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return -9;
      }
      cur[x] = (uint8_t)v;
    }
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = cur.data() + (size_t)x * bpp;
      // 16-bit PNG samples are big-endian
      uint16_t cu = (uint16_t)((px[0] << 8) | px[1]);
      uint16_t cv = (uint16_t)((px[2] << 8) | px[3]);
      uint16_t cm = (uint16_t)((px[4] << 8) | px[5]);
      long i = (long)y * w + x;
      int ok = cm > 0;
      flow[2 * i] = ok ? ((float)cu - 32768.0f) / 64.0f : 0.0f;
      flow[2 * i + 1] = ok ? ((float)cv - 32768.0f) / 64.0f : 0.0f;
      valid[i] = (uint8_t)ok;
    }
    prev.swap(cur);
  }
  *out_w = w;
  *out_h = h;
  return 0;
}

// Encode flow [h*w*2] f32 (+ valid [h*w] u8, may be NULL for all-valid)
// as a KITTI 16-bit RGB PNG (filter-0 rows).  Returns 0 on success.
int kitti_flow_write(const char* path, const float* flow,
                     const uint8_t* valid, int w, int h) {
  const long stride = (long)w * 6;
  std::vector<uint8_t> rows((stride + 1) * (size_t)h);
  for (int y = 0; y < h; ++y) {
    uint8_t* dst = rows.data() + (size_t)y * (stride + 1);
    *dst++ = 0;  // filter type 0
    for (int x = 0; x < w; ++x) {
      long i = (long)y * w + x;
      int ok = valid ? (valid[i] != 0) : 1;
      uint16_t cu = 0, cv = 0, cm = 0;
      if (ok) {
        float qu = flow[2 * i] * 64.0f + 32768.0f;
        float qv = flow[2 * i + 1] * 64.0f + 32768.0f;
        qu = qu < 0.f ? 0.f : (qu > 65535.f ? 65535.f : qu);
        qv = qv < 0.f ? 0.f : (qv > 65535.f ? 65535.f : qv);
        cu = (uint16_t)(qu + 0.5f);
        cv = (uint16_t)(qv + 0.5f);
        cm = 1;
      }
      *dst++ = (uint8_t)(cu >> 8); *dst++ = (uint8_t)(cu & 0xFF);
      *dst++ = (uint8_t)(cv >> 8); *dst++ = (uint8_t)(cv & 0xFF);
      *dst++ = (uint8_t)(cm >> 8); *dst++ = (uint8_t)(cm & 0xFF);
    }
  }
  uLongf zcap = compressBound((uLong)rows.size());
  std::vector<uint8_t> zbuf(zcap);
  if (compress2(zbuf.data(), &zcap, rows.data(), (uLong)rows.size(), 6)
      != Z_OK)
    return -2;

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  auto wr_u32 = [&](uint32_t v) {
    uint8_t b[4] = {(uint8_t)(v >> 24), (uint8_t)(v >> 16),
                    (uint8_t)(v >> 8), (uint8_t)v};
    fwrite(b, 1, 4, f);
  };
  auto chunk = [&](const char* tag, const uint8_t* data, uint32_t len) {
    wr_u32(len);
    fwrite(tag, 1, 4, f);
    if (len) fwrite(data, 1, len, f);
    uLong crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, (const Bytef*)tag, 4);
    if (len) crc = crc32(crc, data, len);
    wr_u32((uint32_t)crc);
  };
  fwrite("\x89PNG\r\n\x1a\n", 1, 8, f);
  uint8_t ihdr[13];
  ihdr[0] = (uint8_t)(w >> 24); ihdr[1] = (uint8_t)(w >> 16);
  ihdr[2] = (uint8_t)(w >> 8);  ihdr[3] = (uint8_t)w;
  ihdr[4] = (uint8_t)(h >> 24); ihdr[5] = (uint8_t)(h >> 16);
  ihdr[6] = (uint8_t)(h >> 8);  ihdr[7] = (uint8_t)h;
  ihdr[8] = 16; ihdr[9] = 2; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", zbuf.data(), (uint32_t)zcap);
  chunk("IEND", nullptr, 0);
  fclose(f);
  return 0;
}

// Peek dims of a PNG file (for buffer allocation).  Returns 0 on success.
int png_peek(const char* path, int* out_w, int* out_h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hd[33];
  size_t got = fread(hd, 1, sizeof hd, f);
  fclose(f);
  if (got < 24 || memcmp(hd, "\x89PNG\r\n\x1a\n", 8) != 0) return -2;
  if (memcmp(hd + 12, "IHDR", 4) != 0) return -3;
  *out_w = (int)rd_u32(hd + 16);
  *out_h = (int)rd_u32(hd + 20);
  return 0;
}

// ---------------------------------------------------------------------------
// .flo codec (Middlebury; IO_flow.cpp semantics)
// ---------------------------------------------------------------------------

int flo_write(const char* path, const float* data, int w, int h, int ch) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int ok = fwrite("PIEH", 1, 4, f) == 4 && fwrite(&w, 4, 1, f) == 1 &&
           fwrite(&h, 4, 1, f) == 1 &&
           fwrite(data, 4, (size_t)w * h * ch, f) == (size_t)w * h * ch;
  fclose(f);
  return ok ? 0 : -2;
}

// Reads header only (peek dims); returns 0 on success.
int flo_peek(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char tag[4];
  int ok = fread(tag, 1, 4, f) == 4 && memcmp(tag, "PIEH", 4) == 0 &&
           fread(w, 4, 1, f) == 1 && fread(h, 4, 1, f) == 1;
  fclose(f);
  return ok ? 0 : -2;
}

int flo_read(const char* path, float* out, long cap, int ch) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char tag[4];
  int w, h;
  if (fread(tag, 1, 4, f) != 4 || memcmp(tag, "PIEH", 4) != 0 ||
      fread(&w, 4, 1, f) != 1 || fread(&h, 4, 1, f) != 1) {
    fclose(f);
    return -2;
  }
  long count = (long)w * h * ch;
  if (count > cap) {
    fclose(f);
    return -3;
  }
  int ok = fread(out, 4, count, f) == (size_t)count;
  // "file too long" check (IO_flow.cpp:50-51)
  int extra = fgetc(f);
  fclose(f);
  if (!ok) return -4;
  if (extra != EOF) return -5;
  return 0;
}

// ---------------------------------------------------------------------------
// Color-wheel flow rasterization (color_coding.cpp)
// ---------------------------------------------------------------------------

static int wheel[55][3];
static int wheel_init_done = 0;

static void wheel_init() {
  if (wheel_init_done) return;
  const int RY = 15, YG = 6, GC = 4, CB = 11, BM = 13, MR = 6;
  int k = 0;
  for (int i = 0; i < RY; ++i, ++k) { wheel[k][0]=255; wheel[k][1]=255*i/RY; wheel[k][2]=0; }
  for (int i = 0; i < YG; ++i, ++k) { wheel[k][0]=255-255*i/YG; wheel[k][1]=255; wheel[k][2]=0; }
  for (int i = 0; i < GC; ++i, ++k) { wheel[k][0]=0; wheel[k][1]=255; wheel[k][2]=255*i/GC; }
  for (int i = 0; i < CB; ++i, ++k) { wheel[k][0]=0; wheel[k][1]=255-255*i/CB; wheel[k][2]=255; }
  for (int i = 0; i < BM; ++i, ++k) { wheel[k][0]=255*i/BM; wheel[k][1]=0; wheel[k][2]=255; }
  for (int i = 0; i < MR; ++i, ++k) { wheel[k][0]=255; wheel[k][1]=0; wheel[k][2]=255-255*i/MR; }
  wheel_init_done = 1;
}

// flow [h*w*2] -> BGR uint8 [h*w*3]; maxmotion<=0 -> per-frame auto max.
void flow_to_bgr(const float* flow, int w, int h, float maxmotion,
                 uint8_t* out) {
  wheel_init();
  const long n = (long)w * h;
  float maxrad = maxmotion;
  if (maxmotion <= 0.f) {
    maxrad = 1.f;
    for (long i = 0; i < n; ++i) {
      float fx = flow[2 * i], fy = flow[2 * i + 1];
      if (!std::isfinite(fx) || !std::isfinite(fy) || fabsf(fx) >= 1e9f ||
          fabsf(fy) >= 1e9f)
        continue;
      float r = sqrtf(fx * fx + fy * fy);
      if (r > maxrad) maxrad = r;
    }
  }
  for (long i = 0; i < n; ++i) {
    float fx = flow[2 * i], fy = flow[2 * i + 1];
    uint8_t* px = out + 3 * i;
    if (!std::isfinite(fx) || !std::isfinite(fy) || fabsf(fx) >= 1e9f ||
        fabsf(fy) >= 1e9f) {
      px[0] = px[1] = px[2] = 0;
      continue;
    }
    fx /= maxrad; fy /= maxrad;
    float rad = sqrtf(fx * fx + fy * fy);
    float a = atan2f(-fy, -fx) / 3.14159265358979323846f;
    float fk = (a + 1.f) / 2.f * (55 - 1);
    int k0 = (int)fk;
    int k1 = (k0 + 1) % 55;
    float fr = fk - k0;
    for (int b = 0; b < 3; ++b) {
      float col0 = wheel[k0][b] / 255.f;
      float col1 = wheel[k1][b] / 255.f;
      float col = (1 - fr) * col0 + fr * col1;
      if (rad <= 1)
        col = 1 - rad * (1 - col);
      else
        col *= .75f;
      px[2 - b] = (uint8_t)(255.f * col);
    }
  }
}

}  // extern "C"
