// Stage-1 label synthesis and the detector's eval images, host code:
// OpenCV's chamfer distance transform and resizes without OpenCV.
//
// chamfer_distance_3x3: the distance of every nonzero pixel of a uint8 mask
// to the nearest zero pixel, by the two-pass 3x3 chamfer that OpenCV's
// distanceTransform(DIST_L2, maskSize=3) computes: weights a = 0.955 for an
// edge step and b = 1.3693 for a diagonal one, running sums in float32.
// Pixels outside the image count as foreground (an infinite distance), not
// as zeros.
//
// resize_linear_f32 / resize_nearest_u8: cv2.resize with INTER_LINEAR on
// float32 (half-pixel taps; positions and fractions in float64, the
// fraction rounded to float32, clamped at the edges; columns blended, then
// rows, in float32), INTER_LINEAR on uint8 (OpenCV's fixed-point path, for
// the detector's eval images) and INTER_NEAREST on uint8 (index floor(x *
// (1 / (dst / src))) in float64).
//
// Built with g++ by unmore_tpu_torch/ops/cuda_build.py and bound with
// ctypes in unmore_tpu_torch/ops/labels.py, which holds the plain numpy
// versions; the bindings release the interpreter lock, so the stage-1
// prefetch threads run these calls in parallel with the training thread.

#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {
constexpr float kEdge = 0.955f;
constexpr float kDiag = 1.3693f;
// outside the image, and the result where no zero pixel exists (as OpenCV);
// FLT_MAX plus a weight rounds back to FLT_MAX
constexpr float kFar = FLT_MAX;

// OpenCV's INTER_LINEAR taps along one axis
void linear_taps(int64_t src, int64_t dst, std::vector<int64_t>& i0, std::vector<int64_t>& i1,
                 std::vector<float>& w0, std::vector<float>& w1) {
    i0.resize(dst), i1.resize(dst), w0.resize(dst), w1.resize(dst);
    const double step = 1.0 / (static_cast<double>(dst) / static_cast<double>(src));
    for (int64_t j = 0; j < dst; j++) {
        const double pos = (static_cast<double>(j) + 0.5) * step - 0.5;
        int64_t lo = static_cast<int64_t>(std::floor(pos));
        float frac = static_cast<float>(pos - static_cast<double>(lo));
        if (lo < 0 || lo >= src - 1) frac = 0.f;
        lo = lo < 0 ? 0 : (lo > src - 1 ? src - 1 : lo);
        i0[j] = lo;
        i1[j] = lo + 1 < src ? lo + 1 : src - 1;
        w0[j] = 1.f - frac;
        w1[j] = frac;
    }
}

// OpenCV's fixed-point INTER_LINEAR taps along one axis: the first source
// index and the two 11-bit weights. The position is a float of a double
// product; along x (`clamp_edges`) an index outside [0, src - 1) takes the
// edge with weight 2048, along y it is left for the caller to clamp.
void fixed_taps(int64_t src, int64_t dst, bool clamp_edges, std::vector<int64_t>& i0, std::vector<int32_t>& w0,
                std::vector<int32_t>& w1) {
    i0.resize(dst), w0.resize(dst), w1.resize(dst);
    const double step = 1.0 / (static_cast<double>(dst) / static_cast<double>(src));
    for (int64_t j = 0; j < dst; j++) {
        float pos = static_cast<float>((static_cast<double>(j) + 0.5) * step - 0.5);
        int64_t lo = static_cast<int64_t>(std::floor(pos));
        pos -= static_cast<float>(lo);
        if (clamp_edges && lo < 0) pos = 0.f, lo = 0;
        if (clamp_edges && lo >= src - 1) pos = 0.f, lo = src - 1;
        i0[j] = lo;
        w0[j] = static_cast<int32_t>(std::lrint((1.f - pos) * 2048.f));
        w1[j] = static_cast<int32_t>(std::lrint(pos * 2048.f));
    }
}

std::vector<int64_t> nearest_index(int64_t src, int64_t dst) {
    std::vector<int64_t> idx(dst);
    const double step = 1.0 / (static_cast<double>(dst) / static_cast<double>(src));
    for (int64_t j = 0; j < dst; j++) {
        const int64_t i = static_cast<int64_t>(std::floor(static_cast<double>(j) * step));
        idx[j] = i < src - 1 ? i : src - 1;
    }
    return idx;
}
}  // namespace

extern "C" {

// src [h, w] uint8 (nonzero = foreground), dst [h, w] float32.
void chamfer_distance_3x3(const uint8_t* src, int64_t h, int64_t w, float* dst) {
    const int64_t stride = w + 2;  // one border column on each side, one border row above and below
    std::vector<float> t(static_cast<size_t>((h + 2) * stride), kFar);
    for (int64_t i = 0; i < h; i++) {  // forward: up-left, up, up-right, left
        float* row = &t[(i + 1) * stride + 1];
        const float* up = row - stride;
        for (int64_t j = 0; j < w; j++) {
            if (!src[i * w + j]) {
                row[j] = 0.f;
                continue;
            }
            float best = up[j - 1] + kDiag, x;
            x = up[j] + kEdge;
            if (best > x) best = x;
            x = up[j + 1] + kDiag;
            if (best > x) best = x;
            x = row[j - 1] + kEdge;
            if (best > x) best = x;
            row[j] = best;
        }
    }
    for (int64_t i = h - 1; i >= 0; i--) {  // backward: down-right, down, down-left, right
        float* row = &t[(i + 1) * stride + 1];
        const float* down = row + stride;
        for (int64_t j = w - 1; j >= 0; j--) {
            float best = row[j];
            if (best > kEdge) {
                float x = down[j + 1] + kDiag;
                if (best > x) best = x;
                x = down[j] + kEdge;
                if (best > x) best = x;
                x = down[j - 1] + kDiag;
                if (best > x) best = x;
                x = row[j + 1] + kEdge;
                if (best > x) best = x;
                row[j] = best;
            }
            dst[i * w + j] = best;
        }
    }
}

// src [h, w, c] float32 with a row stride of `src_row` floats (a crop of a
// larger image may be passed without a copy), dst [H, W, c] float32.
void resize_linear_f32(const float* src, int64_t h, int64_t w, int64_t c, int64_t src_row, float* dst, int64_t H,
                       int64_t W) {
    std::vector<int64_t> y0, y1, x0, x1;
    std::vector<float> wy0, wy1, wx0, wx1;
    linear_taps(h, H, y0, y1, wy0, wy1);
    linear_taps(w, W, x0, x1, wx0, wx1);
    std::vector<float> cols(static_cast<size_t>(h * W * c));  // columns blended, every source row
    for (int64_t y = 0; y < h; y++) {
        const float* s = src + y * src_row;
        float* r = &cols[y * W * c];
        for (int64_t x = 0; x < W; x++)
            for (int64_t k = 0; k < c; k++) {
                const float a = s[x0[x] * c + k] * wx0[x];
                const float b = s[x1[x] * c + k] * wx1[x];
                r[x * c + k] = a + b;
            }
    }
    for (int64_t y = 0; y < H; y++) {
        const float* r0 = &cols[y0[y] * W * c];
        const float* r1 = &cols[y1[y] * W * c];
        float* d = dst + y * W * c;
        for (int64_t i = 0; i < W * c; i++) {
            const float a = r0[i] * wy0[y];
            const float b = r1[i] * wy1[y];
            d[i] = a + b;
        }
    }
}

// src [h, w, c] uint8 with a row stride of `src_row` bytes, dst [H, W, c]
// uint8: cv2.resize(INTER_LINEAR) of uint8, bit for bit. OpenCV resizes
// uint8 in fixed point: 11-bit weights (round(w * 2048)) from float
// positions, columns blended into int32 rows (weights summing to 2048),
// then rows blended as its vector code does, ((r0 >> 4) * b0 >> 16) +
// ((r1 >> 4) * b1 >> 16), rounded by (t + 2) >> 2. Source rows outside the
// image clamp to the edge with the weights unchanged; columns outside it
// take the edge column with weight 2048. An exact 2x downscale in both axes
// is OpenCV's INTER_AREA: the rounded mean of each 2x2 block.
void resize_linear_u8(const uint8_t* src, int64_t h, int64_t w, int64_t c, int64_t src_row, uint8_t* dst, int64_t H,
                      int64_t W) {
    if (h == 2 * H && w == 2 * W) {
        for (int64_t y = 0; y < H; y++) {
            const uint8_t* s0 = src + 2 * y * src_row;
            const uint8_t* s1 = s0 + src_row;
            for (int64_t x = 0; x < W; x++)
                for (int64_t k = 0; k < c; k++) {
                    const int64_t i = 2 * x * c + k;
                    dst[(y * W + x) * c + k] = static_cast<uint8_t>((s0[i] + s0[i + c] + s1[i] + s1[i + c] + 2) >> 2);
                }
        }
        return;
    }
    std::vector<int64_t> x0, x1, y0;
    std::vector<int32_t> ax0, ax1, by0, by1;
    fixed_taps(w, W, true, x0, ax0, ax1);
    fixed_taps(h, H, false, y0, by0, by1);
    x1.resize(W);
    for (int64_t x = 0; x < W; x++) x1[x] = x0[x] + 1 < w ? x0[x] + 1 : w - 1;
    std::vector<int32_t> rows(static_cast<size_t>(h * W * c));  // columns blended, every source row
    for (int64_t y = 0; y < h; y++) {
        const uint8_t* s = src + y * src_row;
        int32_t* r = &rows[y * W * c];
        for (int64_t x = 0; x < W; x++)
            for (int64_t k = 0; k < c; k++) r[x * c + k] = s[x0[x] * c + k] * ax0[x] + s[x1[x] * c + k] * ax1[x];
    }
    for (int64_t y = 0; y < H; y++) {
        const int64_t i0 = y0[y] < 0 ? 0 : (y0[y] > h - 1 ? h - 1 : y0[y]);
        const int64_t i1 = y0[y] + 1 < 0 ? 0 : (y0[y] + 1 > h - 1 ? h - 1 : y0[y] + 1);
        const int32_t* r0 = &rows[i0 * W * c];
        const int32_t* r1 = &rows[i1 * W * c];
        uint8_t* d = dst + y * W * c;
        for (int64_t i = 0; i < W * c; i++) {
            const int32_t t = (((r0[i] >> 4) * by0[y]) >> 16) + (((r1[i] >> 4) * by1[y]) >> 16);
            const int32_t v = (t + 2) >> 2;
            d[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
        }
    }
}

// src [h, w] uint8 with a row stride of `src_row` bytes, dst [H, W] uint8.
void resize_nearest_u8(const uint8_t* src, int64_t h, int64_t w, int64_t src_row, uint8_t* dst, int64_t H, int64_t W) {
    const std::vector<int64_t> iy = nearest_index(h, H), ix = nearest_index(w, W);
    for (int64_t y = 0; y < H; y++) {
        const uint8_t* s = src + iy[y] * src_row;
        for (int64_t x = 0; x < W; x++) dst[y * W + x] = s[ix[x]];
    }
}

}  // extern "C"
