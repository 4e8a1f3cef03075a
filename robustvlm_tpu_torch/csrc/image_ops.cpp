// Host-side image pipeline for the data loaders: antialiased bicubic
// resize (PIL convention, a = -0.5, support scaled by the downscale factor)
// and uint8 HWC -> float32 CHW [0,1] conversion, in C++ with a std::thread
// row pool, exposed through a C ABI for ctypes
// (robustvlm_tpu_torch/data/native.py).
//
// The port's own copy of the JAX package's native/image_ops.cpp, the same
// source built with the same flags, so both give the same bits. Built at
// first use by data/native.py with g++ into build/native/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr double kA = -0.5;  // PIL bicubic

inline double bicubic(double x) {
  x = std::abs(x);
  if (x < 1.0) return ((kA + 2.0) * x - (kA + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * kA;
  return 0.0;
}

struct WeightTable {
  std::vector<int> bounds;     // 2 per output idx: start, size
  std::vector<double> weights; // ksize per output idx
  int ksize;
};

// PIL-style precomputed separable coefficients (antialias: filter support
// widens by the downscale factor).
WeightTable compute_weights(int in_size, int out_size) {
  WeightTable t;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 2.0 * filterscale;
  t.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  t.bounds.resize(2 * out_size);
  t.weights.assign(static_cast<size_t>(out_size) * t.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double* w = &t.weights[static_cast<size_t>(xx) * t.ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      double v = bicubic((x + xmin - center + 0.5) / filterscale);
      w[x] = v;
      ww += v;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) w[x] /= ww;
    t.bounds[2 * xx] = xmin;
    t.bounds[2 * xx + 1] = xmax;
  }
  return t;
}

void parallel_rows(int n, int n_threads, const std::function<void(int, int)>& fn) {
  if (n_threads <= 1 || n < 2 * n_threads) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// src: uint8 HWC (sh, sw, c); dst: float32 CHW (c, dh, dw) in [0, 1].
void resize_bicubic_u8_chw(const uint8_t* src, int sh, int sw, int c,
                           float* dst, int dh, int dw, int n_threads) {
  WeightTable wx = compute_weights(sw, dw);
  WeightTable wy = compute_weights(sh, dh);
  std::vector<float> wxf(wx.weights.begin(), wx.weights.end());
  std::vector<float> wyf(wy.weights.begin(), wy.weights.end());

  // pass 1: horizontal, planar f32 intermediate (c, sh, dw) so pass 2
  // reduces over contiguous columns per channel
  std::vector<float> tmp(static_cast<size_t>(c) * sh * dw);
  const size_t plane = static_cast<size_t>(sh) * dw;
  parallel_rows(sh, n_threads, [&](int lo, int hi) {
    for (int y = lo; y < hi; ++y) {
      const uint8_t* srow = src + static_cast<size_t>(y) * sw * c;
      for (int xx = 0; xx < dw; ++xx) {
        int xmin = wx.bounds[2 * xx], xmax = wx.bounds[2 * xx + 1];
        const float* w = &wxf[static_cast<size_t>(xx) * wx.ksize];
        float a0 = 0.f, a1 = 0.f, a2 = 0.f;
        const uint8_t* p = srow + static_cast<size_t>(xmin) * c;
        if (c == 3) {
          for (int x = 0; x < xmax; ++x, p += 3) {
            float wv = w[x];
            a0 += p[0] * wv;
            a1 += p[1] * wv;
            a2 += p[2] * wv;
          }
          // PIL clamps the intermediate pass; clamping removes the
          // overshoot divergence at upscale
          tmp[0 * plane + static_cast<size_t>(y) * dw + xx] =
              std::min(255.f, std::max(0.f, a0));
          tmp[1 * plane + static_cast<size_t>(y) * dw + xx] =
              std::min(255.f, std::max(0.f, a1));
          tmp[2 * plane + static_cast<size_t>(y) * dw + xx] =
              std::min(255.f, std::max(0.f, a2));
        } else {
          for (int ch = 0; ch < c; ++ch) {
            float acc = 0.f;
            for (int x = 0; x < xmax; ++x)
              acc += p[x * c + ch] * w[x];
            tmp[static_cast<size_t>(ch) * plane + static_cast<size_t>(y) * dw + xx] =
                std::min(255.f, std::max(0.f, acc));
          }
        }
      }
    }
  });

  // pass 2: vertical over planar rows (vectorizable along xx) + [0,1] scale
  const float inv255 = 1.0f / 255.0f;
  parallel_rows(dh, n_threads, [&](int lo, int hi) {
    std::vector<float> acc(dw);
    for (int yy = lo; yy < hi; ++yy) {
      int ymin = wy.bounds[2 * yy], ymax = wy.bounds[2 * yy + 1];
      const float* w = &wyf[static_cast<size_t>(yy) * wy.ksize];
      for (int ch = 0; ch < c; ++ch) {
        std::fill(acc.begin(), acc.end(), 0.f);
        const float* pl = &tmp[static_cast<size_t>(ch) * plane];
        for (int y = 0; y < ymax; ++y) {
          const float* row = pl + static_cast<size_t>(ymin + y) * dw;
          float wv = w[y];
          for (int xx = 0; xx < dw; ++xx) acc[xx] += row[xx] * wv;
        }
        float* drow = &dst[(static_cast<size_t>(ch) * dh + yy) * dw];
        for (int xx = 0; xx < dw; ++xx)
          drow[xx] = std::min(255.f, std::max(0.f, acc[xx])) * inv255;
      }
    }
  });
}

// Plain layout conversion: uint8 HWC -> float32 CHW [0,1].
void u8_hwc_to_f32_chw(const uint8_t* src, int h, int w, int c, float* dst,
                       int n_threads) {
  const float inv255 = 1.0f / 255.0f;
  parallel_rows(h, n_threads, [&](int lo, int hi) {
    for (int y = lo; y < hi; ++y)
      for (int x = 0; x < w; ++x)
        for (int ch = 0; ch < c; ++ch)
          dst[(static_cast<size_t>(ch) * h + y) * w + x] =
              src[(static_cast<size_t>(y) * w + x) * c + ch] * inv255;
  });
}

// Center-crop + resize fused: resize shorter side to `size` then crop.
void resize_center_crop_u8_chw(const uint8_t* src, int sh, int sw, int c,
                               float* dst, int size, int n_threads) {
  int nh, nw;
  if (sh <= sw) {
    nh = size;
    nw = static_cast<int>(std::lround(static_cast<double>(sw) * size / sh));
  } else {
    nw = size;
    nh = static_cast<int>(std::lround(static_cast<double>(sh) * size / sw));
  }
  std::vector<float> full(static_cast<size_t>(c) * nh * nw);
  resize_bicubic_u8_chw(src, sh, sw, c, full.data(), nh, nw, n_threads);
  int top = (nh - size) / 2, left = (nw - size) / 2;
  for (int ch = 0; ch < c; ++ch)
    for (int y = 0; y < size; ++y)
      std::memcpy(
          &dst[(static_cast<size_t>(ch) * size + y) * size],
          &full[(static_cast<size_t>(ch) * nh + (top + y)) * nw + left],
          sizeof(float) * size);
}

}  // extern "C"
