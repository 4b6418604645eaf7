// Host image preprocessing of the port's data feed (own copy of the JAX
// package's csrc/preprocess.cc, with the same semantics and results):
//
//   wide uint8 (Hs, Ws, 3)
//     -> separable triangle-filter resize (PIL BILINEAR semantics:
//        support = max(scale, 1), half-pixel centers, weights renormalized)
//     -> view split along width
//     -> /255 and per-channel mean/std normalize
//   directly into the (V, Ho, Wv, 3) float32 output the model consumes.
//
// Both passes run in f32 (Pillow rounds the horizontal pass to uint8), so
// outputs can differ from PIL by <= 2/255 per channel.
//
// Every multiply-add is an explicit fused multiply-add: the results are
// those of the JAX package's library, which its build (-march=native)
// lets the compiler contract into FMA instructions, whatever flags this
// file is built with.
//
// Single-threaded; ctypes releases the GIL, so the loader's threads run
// these calls side by side. C ABI, bound in bevrender_tpu_torch/data/
// native.py.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Precomputed sampling plan for one axis of a triangle-filter resample.
struct AxisPlan {
  std::vector<int> first;      // first source index per output index
  std::vector<int> count;      // number of taps per output index
  std::vector<float> weights;  // taps, packed [out][k], stride = max_count
  int max_count = 0;
};

// PIL-compatible plan: center = (i + 0.5) * scale, support = max(scale, 1),
// triangle weights renormalized to sum 1.
AxisPlan make_plan(int in_size, int out_size) {
  AxisPlan plan;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = filterscale;  // triangle filter support = 1.0
  const double inv = 1.0 / filterscale;
  plan.max_count = static_cast<int>(std::ceil(support)) * 2 + 1;
  plan.first.resize(out_size);
  plan.count.resize(out_size);
  plan.weights.assign(static_cast<size_t>(out_size) * plan.max_count, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    int xmax = static_cast<int>(center + support + 0.5);
    xmin = std::max(xmin, 0);
    xmax = std::min(xmax, in_size);
    double total = 0.0;
    std::vector<double> w(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      const double d = (x + 0.5 - center) * inv;
      const double t = std::abs(d) < 1.0 ? 1.0 - std::abs(d) : 0.0;
      w[x - xmin] = t;
      total += t;
    }
    if (total <= 0.0) {  // degenerate (out_size >> in_size edge); nearest
      const int x = std::min(std::max(static_cast<int>(center), 0), in_size - 1);
      xmin = x;
      xmax = x + 1;
      w.assign(1, 1.0);
      total = 1.0;
    }
    plan.first[i] = xmin;
    plan.count[i] = xmax - xmin;
    for (int k = 0; k < xmax - xmin; ++k) {
      plan.weights[static_cast<size_t>(i) * plan.max_count + k] =
          static_cast<float>(w[k] / total);
    }
  }
  return plan;
}

// Horizontal pass: u8 (hs, ws, 3) -> f32 (hs, wo, 3).
void hpass(const uint8_t* src, int hs, int ws, const AxisPlan& px, int wo,
           float* tmp) {
  for (int y = 0; y < hs; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * ws * 3;
    float* out = tmp + static_cast<size_t>(y) * wo * 3;
    for (int x = 0; x < wo; ++x) {
      const float* w = &px.weights[static_cast<size_t>(x) * px.max_count];
      const uint8_t* p = row + static_cast<size_t>(px.first[x]) * 3;
      float r = 0.f, g = 0.f, b = 0.f;
      const int n = px.count[x];
      for (int k = 0; k < n; ++k) {
        const float wk = w[k];
        r = std::fma(wk, static_cast<float>(p[3 * k + 0]), r);
        g = std::fma(wk, static_cast<float>(p[3 * k + 1]), g);
        b = std::fma(wk, static_cast<float>(p[3 * k + 2]), b);
      }
      out[3 * x + 0] = r;
      out[3 * x + 1] = g;
      out[3 * x + 2] = b;
    }
  }
}

}  // namespace

extern "C" {

// Fused: wide u8 (hs, ws, 3) -> resize to (ho, wo) -> split width into v
// views -> /255 -> (x - mean) / std, written as f32 (v, ho, wo / v, 3).
// mean/stdv are 3-element per-channel arrays. wo must be divisible by v.
void bev_fused_views(const uint8_t* src, int hs, int ws, float* dst, int v,
                     int ho, int wo, const float* mean, const float* stdv) {
  if (hs == ho && ws == wo) {
    // identity resize (e.g. a cached post-resize frame): one direct
    // split+normalize pass, no filter plans, no intermediate buffer
    const int wv = wo / v;
    const float s0 = 1.0f / (255.0f * stdv[0]), m0 = mean[0] / stdv[0];
    const float s1 = 1.0f / (255.0f * stdv[1]), m1 = mean[1] / stdv[1];
    const float s2 = 1.0f / (255.0f * stdv[2]), m2 = mean[2] / stdv[2];
    for (int yo = 0; yo < ho; ++yo) {
      const uint8_t* row = src + static_cast<size_t>(yo) * wo * 3;
      for (int gx = 0; gx < wo; ++gx) {
        const int vi = gx / wv;
        const int x = gx - vi * wv;
        float* o = dst + ((static_cast<size_t>(vi) * ho + yo) * wv + x) * 3;
        o[0] = std::fma(static_cast<float>(row[3 * gx + 0]), s0, -m0);
        o[1] = std::fma(static_cast<float>(row[3 * gx + 1]), s1, -m1);
        o[2] = std::fma(static_cast<float>(row[3 * gx + 2]), s2, -m2);
      }
    }
    return;
  }
  const AxisPlan px = make_plan(ws, wo);
  const AxisPlan py = make_plan(hs, ho);
  std::vector<float> tmp(static_cast<size_t>(hs) * wo * 3);
  hpass(src, hs, ws, px, wo, tmp.data());

  const int wv = wo / v;
  const float s0 = 1.0f / (255.0f * stdv[0]), m0 = mean[0] / stdv[0];
  const float s1 = 1.0f / (255.0f * stdv[1]), m1 = mean[1] / stdv[1];
  const float s2 = 1.0f / (255.0f * stdv[2]), m2 = mean[2] / stdv[2];
  for (int yo = 0; yo < ho; ++yo) {
    const float* wy = &py.weights[static_cast<size_t>(yo) * py.max_count];
    const int y0 = py.first[yo];
    const int ny = py.count[yo];
    for (int gx = 0; gx < wo; ++gx) {
      float r = 0.f, g = 0.f, b = 0.f;
      for (int k = 0; k < ny; ++k) {
        const float* p =
            tmp.data() + (static_cast<size_t>(y0 + k) * wo + gx) * 3;
        const float wk = wy[k];
        r = std::fma(wk, p[0], r);
        g = std::fma(wk, p[1], g);
        b = std::fma(wk, p[2], b);
      }
      const int vi = gx / wv;
      const int x = gx - vi * wv;
      float* o = dst + ((static_cast<size_t>(vi) * ho + yo) * wv + x) * 3;
      o[0] = std::fma(r, s0, -m0);
      o[1] = std::fma(g, s1, -m1);
      o[2] = std::fma(b, s2, -m2);
    }
  }
}

// u8 (hs, ws, 3) -> u8 (ho, wo, 3) triangle-filter resize, rounded.
void bev_resize_u8(const uint8_t* src, int hs, int ws, uint8_t* dst, int ho,
                   int wo) {
  const AxisPlan px = make_plan(ws, wo);
  const AxisPlan py = make_plan(hs, ho);
  std::vector<float> tmp(static_cast<size_t>(hs) * wo * 3);
  hpass(src, hs, ws, px, wo, tmp.data());
  for (int yo = 0; yo < ho; ++yo) {
    const float* wy = &py.weights[static_cast<size_t>(yo) * py.max_count];
    const int y0 = py.first[yo];
    const int ny = py.count[yo];
    uint8_t* out = dst + static_cast<size_t>(yo) * wo * 3;
    for (int gx = 0; gx < wo; ++gx) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < ny; ++k) {
        const float* p =
            tmp.data() + (static_cast<size_t>(y0 + k) * wo + gx) * 3;
        const float wk = wy[k];
        acc[0] = std::fma(wk, p[0], acc[0]);
        acc[1] = std::fma(wk, p[1], acc[1]);
        acc[2] = std::fma(wk, p[2], acc[2]);
      }
      for (int c = 0; c < 3; ++c) {
        const float r = acc[c] + 0.5f;
        out[3 * gx + c] =
            static_cast<uint8_t>(std::min(std::max(r, 0.0f), 255.0f));
      }
    }
  }
}

// u8 -> f32 / 255 (the map tile's ToTensor).
void bev_u8_to_unit_f32(const uint8_t* src, float* dst, int64_t n) {
  // thread-safe static init: the loader's threads enter here at once
  static const auto lut = [] {
    std::array<float, 256> t{};
    for (int i = 0; i < 256; ++i) t[i] = i * (1.0f / 255.0f);
    return t;
  }();
  for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// Stack n arrays of nbytes each into one contiguous output.
void bev_stack(const void** srcs, int n, int64_t nbytes, void* dst) {
  for (int i = 0; i < n; ++i) {
    std::memcpy(static_cast<char*>(dst) + static_cast<int64_t>(i) * nbytes,
                srcs[i], nbytes);
  }
}

}  // extern "C"
