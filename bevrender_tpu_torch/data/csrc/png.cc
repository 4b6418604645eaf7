// PNG scanline decoding of the port's data feed. Python parses the chunks
// and inflates the IDAT stream with the standard library's zlib
// (bevrender_tpu_torch/data/png.py); this file undoes the per-row filters
// (None, Sub, Up, Average, Paeth) and converts the pixels to RGB8, then,
// for the fused entry points, hands the frame to preprocess.cc's resize
// without it crossing back into Python.
//
// Formats: non-interlaced gray (bit depth 1, 2, 4 or 8), RGB (8), palette
// (1, 2, 4 or 8), gray + alpha (8) and RGBA (8). Alpha is dropped, as
// PIL's convert("RGB") drops it; a tRNS chunk is ignored. png.py refuses
// every other format before calling in.
//
// Every function returns 0 on success, else: 1 the stream is shorter than
// the image, 2 a row has an unknown filter type, 3 a palette index lies
// past the palette, 4 the format is not one of the above, 5 the output
// width does not split into the views.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
// preprocess.cc (same library)
void bev_fused_views(const uint8_t* src, int hs, int ws, float* dst, int v,
                     int ho, int wo, const float* mean, const float* stdv);
void bev_resize_u8(const uint8_t* src, int hs, int ws, uint8_t* dst, int ho,
                   int wo);
}

namespace {

int channels(int color_type) {
  switch (color_type) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool supported(int color_type, int depth) {
  if (depth == 8) return channels(color_type) > 0;
  return (color_type == 0 || color_type == 3) &&
         (depth == 1 || depth == 2 || depth == 4);
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// The unfiltered rows, stride bytes each, into rows (h * stride).
int unfilter(const uint8_t* data, int64_t n, int h, int64_t stride, int bpp,
             std::vector<uint8_t>* rows) {
  if (n < static_cast<int64_t>(h) * (stride + 1)) return 1;
  rows->resize(static_cast<size_t>(h) * stride);
  uint8_t* out = rows->data();
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = data + static_cast<int64_t>(y) * (stride + 1);
    const int filter = in[0];
    ++in;
    uint8_t* cur = out + static_cast<int64_t>(y) * stride;
    const uint8_t* up = y ? cur - stride : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(cur, in, stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = in[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) cur[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          const int above = up ? up[i] : 0;
          cur[i] = in[i] + ((left + above) >> 1);
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int left = i >= bpp ? cur[i - bpp] : 0;
          const int above = up ? up[i] : 0;
          const int corner = (up && i >= bpp) ? up[i - bpp] : 0;
          cur[i] = in[i] + paeth(left, above, corner);
        }
        break;
      default:
        return 2;
    }
  }
  return 0;
}

// Unfiltered rows -> RGB8 (h, w, 3).
int to_rgb(const uint8_t* rows, int h, int w, int64_t stride, int color_type,
           int depth, const uint8_t* palette, int n_palette, uint8_t* dst) {
  const int nch = channels(color_type);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rows + static_cast<int64_t>(y) * stride;
    uint8_t* o = dst + static_cast<int64_t>(y) * w * 3;
    if (depth == 8 && color_type != 3) {
      for (int x = 0; x < w; ++x) {
        const uint8_t* p = row + static_cast<int64_t>(x) * nch;
        if (nch >= 3) {
          o[3 * x] = p[0];
          o[3 * x + 1] = p[1];
          o[3 * x + 2] = p[2];
        } else {
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = p[0];
        }
      }
      continue;
    }
    // gray or palette, 1-8 bits a pixel, the first pixel in the high bits
    const int mask = (1 << depth) - 1;
    const int per_byte = 8 / depth;
    for (int x = 0; x < w; ++x) {
      const int shift = 8 - depth * (x % per_byte + 1);
      const int v = (row[x / per_byte] >> shift) & mask;
      if (color_type == 3) {
        if (v >= n_palette) return 3;
        std::memcpy(o + 3 * x, palette + 3 * v, 3);
      } else {
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] =
            static_cast<uint8_t>(v * 255 / mask);
      }
    }
  }
  return 0;
}

int decode(const uint8_t* data, int64_t n, int h, int w, int color_type,
           int depth, const uint8_t* palette, int n_palette,
           std::vector<uint8_t>* rgb) {
  if (!supported(color_type, depth) || h <= 0 || w <= 0) return 4;
  const int bits = channels(color_type) * depth;
  const int64_t stride = (static_cast<int64_t>(w) * bits + 7) / 8;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  std::vector<uint8_t> rows;
  int rc = unfilter(data, n, h, stride, bpp, &rows);
  if (rc) return rc;
  rgb->resize(static_cast<size_t>(h) * w * 3);
  return to_rgb(rows.data(), h, w, stride, color_type, depth, palette,
                n_palette, rgb->data());
}

}  // namespace

extern "C" {

// The inflated IDAT stream (n bytes) of an h x w image -> RGB8 (h, w, 3).
int bev_png_decode_rgb(const uint8_t* data, int64_t n, int h, int w,
                       int color_type, int depth, const uint8_t* palette,
                       int n_palette, uint8_t* dst) {
  std::vector<uint8_t> rgb;
  const int rc =
      decode(data, n, h, w, color_type, depth, palette, n_palette, &rgb);
  if (!rc) std::memcpy(dst, rgb.data(), rgb.size());
  return rc;
}

// Decode, resize to (ho, wo), split into v views, /255 and normalise:
// (v, ho, wo / v, 3) float32, as bev_fused_views.
int bev_png_views(const uint8_t* data, int64_t n, int h, int w,
                  int color_type, int depth, const uint8_t* palette,
                  int n_palette, float* dst, int v, int ho, int wo,
                  const float* mean, const float* stdv) {
  if (v <= 0 || wo % v) return 5;
  std::vector<uint8_t> rgb;
  const int rc =
      decode(data, n, h, w, color_type, depth, palette, n_palette, &rgb);
  if (rc) return rc;
  bev_fused_views(rgb.data(), h, w, dst, v, ho, wo, mean, stdv);
  return 0;
}

// Decode and resize to uint8 (ho, wo, 3); a copy at the source size.
int bev_png_resize_u8(const uint8_t* data, int64_t n, int h, int w,
                      int color_type, int depth, const uint8_t* palette,
                      int n_palette, uint8_t* dst, int ho, int wo) {
  std::vector<uint8_t> rgb;
  const int rc =
      decode(data, n, h, w, color_type, depth, palette, n_palette, &rgb);
  if (rc) return rc;
  if (h == ho && w == wo) {
    std::memcpy(dst, rgb.data(), rgb.size());
  } else {
    bev_resize_u8(rgb.data(), h, w, dst, ho, wo);
  }
  return 0;
}

}  // extern "C"
