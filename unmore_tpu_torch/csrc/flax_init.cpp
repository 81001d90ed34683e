// flax's random leaves on the host: jax.random's truncated normal and normal
// float32 draws (threefry2x32, partitionable layout) with XLA's CPU erf_inv,
// element by element. It computes what unmore_tpu_torch/utils/prng.py
// computes with torch ops, in the same float32 steps: a multiply feeding an
// add rounds once (XLA's CPU code contracts the pair), emulated in double as
// prng.py does; division and sqrt round the double result. Built with
// -ffp-contract=off, so that the compiler contracts nothing else.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

inline void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x0, uint32_t& x1) {
  static const int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
  for (int i = 0; i < 5; ++i) {
    for (int j = 0; j < 4; ++j) {
      const int r = kRot[i % 2][j];
      x0 += x1;
      x1 = ((x1 << r) | (x1 >> (32 - r))) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

inline float fma32(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) + static_cast<double>(c));
}

inline float div32(float a, float b) { return static_cast<float>(static_cast<double>(a) / static_cast<double>(b)); }

inline float sqrt32(float a) { return static_cast<float>(std::sqrt(static_cast<double>(a))); }

inline float bits_to_float(uint32_t b) {
  float f;
  std::memcpy(&f, &b, 4);
  return f;
}

inline uint32_t float_to_bits(float f) {
  uint32_t b;
  std::memcpy(&b, &f, 4);
  return b;
}

// Cephes' logf, as XLA's CPU code runs it (prng._logf)
inline float logf_xla(float y) {
  const float tiny = std::numeric_limits<float>::min();
  y = y > tiny ? y : tiny;
  const uint32_t bits = float_to_bits(y);
  float e = static_cast<float>(static_cast<int32_t>(bits >> 23) - 126);
  const float m = bits_to_float((bits & 0x7FFFFFu) | 0x3F000000u);
  const bool low = m < 0.707106781186547524f;
  const float t = (m - 1.0f) + (low ? m : 0.0f);
  e = e - (low ? 1.0f : 0.0f);
  const float t2 = t * t;
  const float t3 = t2 * t;
  const float a = fma32(fma32(t, 7.0376836292e-2f, -1.1514610310e-1f), t, 1.1676998740e-1f);
  const float b = fma32(fma32(t, -1.2420140846e-1f, 1.4249322787e-1f), t, -1.6668057665e-1f);
  const float c = fma32(fma32(t, 2.0000714765e-1f, -2.4999993993e-1f), t, 3.3333331174e-1f);
  const float poly = fma32(fma32(fma32(a, t3, b), t3, c), t3, e * -2.12194440e-4f);
  return ((t - t2 * 0.5f) + poly) + e * 0.693359375f;
}

const float kLog1pNum[7] = {4.5270000862445199635215e-5f, 4.9854102823193375972212e-1f,
                            6.5787325942061044846969e0f,  2.9911919328553073277375e1f,
                            6.0949667980987787057556e1f,  5.7112963590585538103336e1f,
                            2.0039553499201281259648e1f};
const float kLog1pDen[7] = {1.0f,
                            1.5062909083469192043167e1f,
                            8.3047565967967209469434e1f,
                            2.2176239823732856465394e2f,
                            3.0909872225312059774938e2f,
                            2.1642788614495947685003e2f,
                            6.0118660497603843919306e1f};

// XLA's CPU log1p (prng.log1p)
inline float log1p_xla(float x) {
  if (!(std::fabs(x) < 0.41421356237309504880f)) return logf_xla(x + 1.0f);
  float num = kLog1pNum[0], den = kLog1pDen[0];
  for (int i = 1; i < 7; ++i) {
    num = fma32(num, x, kLog1pNum[i]);
    den = fma32(den, x, kLog1pDen[i]);
  }
  const float x2 = x * x;
  return x + (x2 * -0.5f + (x * x2) * div32(num, den));
}

const float kErfInvSmall[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f, 0.00021858087f,
                               -0.00125372503f, -0.00417768164f, 0.246640727f,   1.50140941f};
const float kErfInvLarge[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f, 0.00573950773f,
                               -0.0076224613f,   0.00943887047f,  1.00167406f,    2.83297682f};

// XLA's float32 erf_inv (prng.erf_inv)
inline float erf_inv_xla(float x) {
  float w = -log1p_xla(-x * x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrt32(w) - 3.0f;
  const float* c = lt ? kErfInvSmall : kErfInvLarge;
  float p = c[0];
  for (int i = 1; i < 9; ++i) p = fma32(p, w, c[i]);
  return x * (std::fabs(x) == 1.0f ? std::numeric_limits<float>::infinity() : p);
}

// uniform float32 in [0, 1) from counter c of the key's stream
inline float unit_float(uint32_t k1, uint32_t k2, uint64_t c) {
  uint32_t x0 = static_cast<uint32_t>(c >> 32), x1 = static_cast<uint32_t>(c);
  threefry2x32(k1, k2, x0, x1);
  return bits_to_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

void draw_range(uint32_t k1, uint32_t k2, int64_t lo, int64_t hi, int kind, float scale, float* out) {
  const float sqrt2 = 1.41421356237309504880f;
  if (kind == 0) {  // truncated normal on (-2, 2), then times scale
    const float a = -0.9544997f, b = 0.9544997f, span = b - a;
    const float lower = std::nextafter(-2.0f, 0.0f), upper = std::nextafter(2.0f, 0.0f);
    for (int64_t i = lo; i < hi; ++i) {
      float u = fma32(unit_float(k1, k2, static_cast<uint64_t>(i)), span, a);
      u = u > a ? u : a;
      float v = erf_inv_xla(u) * sqrt2;
      v = v < lower ? lower : (v > upper ? upper : v);
      out[i] = v * scale;
    }
  } else {  // normal times scale, sqrt(2) folded into scale
    const float a = std::nextafter(-1.0f, 0.0f);
    for (int64_t i = lo; i < hi; ++i) {
      float u = fma32(unit_float(k1, k2, static_cast<uint64_t>(i)), 1.0f - a, a);
      u = u > a ? u : a;
      out[i] = erf_inv_xla(u) * scale;
    }
  }
}

}  // namespace

extern "C" {

// out[i] for i < n: element i of the draw under the key (k1, k2). kind 0:
// truncated_normal(-2, 2) * scale; kind 1: erf_inv(u) * scale of normal's
// uniform u, scale = float32(sqrt(2)) * float32(stddev). Splits the elements
// over `threads` threads.
void flax_draw(uint32_t k1, uint32_t k2, int64_t n, int32_t kind, float scale, float* out, int32_t threads) {
  if (threads < 1) threads = 1;
  const int64_t per = (n + threads - 1) / threads;
  if (threads == 1 || n < 65536) {
    draw_range(k1, k2, 0, n, kind, scale, out);
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    const int64_t lo = t * per, hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    pool.emplace_back(draw_range, k1, k2, lo, hi, kind, scale, out);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
