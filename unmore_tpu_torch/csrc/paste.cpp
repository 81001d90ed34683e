// paste: host library of the port's stage-2 scoring (COCO RLE codec and
// the paste-back of crop-space masks), a copy of what scoring needs from
// the repository's cpp/unmore_native.cpp. Host code, not a device kernel:
// it runs on the CPU after the device pass, as it does in the JAX package.
// Plain C interface, built with g++ and loaded with ctypes by
// unmore_tpu_torch/ops/paste.py; its plain versions are
// unmore_tpu_torch/utils/rle.py and ops/image.py's paste_mask_into_canvas.
//
// Masks are row-major uint8 [h, w]; RLE runs are column-major (Fortran)
// order per the COCO spec, starting with a (possibly empty) run of 0s.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- RLE codec

// mask [h*w] row-major -> runs. Returns the number of runs (<= h*w+1).
int64_t rle_from_mask(const uint8_t* mask, int64_t h, int64_t w, int64_t* runs_out) {
    int64_t m = 0;
    int64_t count = 0;
    uint8_t cur = 0;
    for (int64_t x = 0; x < w; ++x) {
        for (int64_t y = 0; y < h; ++y) {
            uint8_t v = mask[y * w + x] ? 1 : 0;
            if (v != cur) {
                runs_out[m++] = count;
                count = 0;
                cur = v;
            }
            ++count;
        }
    }
    runs_out[m++] = count;
    return m;
}

// runs -> COCO counts string (signed 5-bit groups, offset 48, delta
// coding from the 3rd run). Returns the string length; the caller's
// buffer must hold >= 7 chars per run.
int64_t rle_encode_counts(const int64_t* runs, int64_t n_runs, char* out) {
    int64_t p = 0;
    for (int64_t i = 0; i < n_runs; ++i) {
        int64_t x = runs[i];
        if (i > 2) x -= runs[i - 2];
        bool more = true;
        while (more) {
            int64_t c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            out[p++] = (char)(c + 48);
        }
    }
    return p;
}

// counts string -> runs. Returns the number of runs.
int64_t rle_decode_counts(const char* s, int64_t len, int64_t* runs_out) {
    int64_t m = 0;
    int64_t i = 0;
    while (i < len) {
        int64_t x = 0;
        int64_t k = 0;
        while (true) {
            int64_t c = (int64_t)s[i] - 48;
            x |= (c & 0x1f) << (5 * k);
            ++i;
            if (!(c & 0x20)) {
                if (c & 0x10) x |= ~((int64_t)0) << (5 * (k + 1));  // sign extend
                break;
            }
            ++k;
        }
        if (m > 2) x += runs_out[m - 2];
        runs_out[m++] = x;
    }
    return m;
}

// -------------------------------------------- mask paste-back (scoring)
//
// Support (positivity) of the bilinear paste of a crop-space mask into
// a full-image canvas at the integer box extent: exactly the support of
// ops/image.py's paste_mask_into_canvas (wy @ mask @ wx^T, half-pixel
// taps, then > 0). All weights are nonnegative, so output (j, i) > 0 iff
// a tapped source pixel with positive weight is set: the lo tap always
// takes part (1 - frac > 0 since frac is in [0, 1)), the hi tap only when
// frac > 0. Tight boxes, areas and the RLE of the pasted union mask are
// integer work with no full-canvas materialization.

struct PasteAxis {
    std::vector<int32_t> lo, hi;
    std::vector<uint8_t> use_hi;
};

static void paste_axis(int64_t in, int64_t out, PasteAxis& ax) {
    ax.lo.resize((size_t)out);
    ax.hi.resize((size_t)out);
    ax.use_hi.resize((size_t)out);
    double scale = (double)in / (double)out;
    double lim = (double)(in - 1);
    for (int64_t j = 0; j < out; ++j) {
        double src = ((double)j + 0.5) * scale - 0.5;
        if (src < 0.0) src = 0.0;
        if (src > lim) src = lim;
        double lof = std::floor(src);
        int64_t lo = (int64_t)lof;
        ax.lo[j] = (int32_t)lo;
        ax.hi[j] = (int32_t)std::min(lo + 1, in - 1);
        ax.use_hi[j] = (src - lof) > 0.0 ? 1 : 0;
    }
}

static void paste_box_bounds(const float* box, int64_t H, int64_t W,
                             int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
    x1 = std::max<int64_t>((int64_t)std::floor((double)box[0]), 0);
    y1 = std::max<int64_t>((int64_t)std::floor((double)box[1]), 0);
    x2 = std::min<int64_t>((int64_t)std::ceil((double)box[2]), W);
    y2 = std::min<int64_t>((int64_t)std::ceil((double)box[3]), H);
}

static inline bool paste_support_at(const uint8_t* m, int64_t sw,
                                    const PasteAxis& ay, const PasteAxis& ax,
                                    int64_t j, int64_t i) {
    const uint8_t* r0 = m + (int64_t)ay.lo[j] * sw;
    int32_t c0 = ax.lo[i], c1 = ax.hi[i];
    uint8_t ux = ax.use_hi[i];
    if (r0[c0] || (ux && r0[c1])) return true;
    if (!ay.use_hi[j]) return false;
    const uint8_t* r1 = m + (int64_t)ay.hi[j] * sw;
    return r1[c0] || (ux && r1[c1]);
}

// Batched tight boxes (xyxy, xmax+1/ymax+1 convention) and pasted areas
// of n crop-space masks [n, sh, sw] at boxes [n, 4] in an (H, W) canvas.
// An empty paste gives an all-zero tight box and area 0.
void paste_support_stats(const uint8_t* masks, int64_t n, int64_t sh, int64_t sw,
                         const float* boxes, int64_t H, int64_t W,
                         float* tight_out, int64_t* area_out) {
    PasteAxis ay, ax;
    for (int64_t b = 0; b < n; ++b) {
        const uint8_t* m = masks + b * sh * sw;
        int64_t x1, y1, x2, y2;
        paste_box_bounds(boxes + b * 4, H, W, x1, y1, x2, y2);
        int64_t bh = y2 - y1, bw = x2 - x1;
        int64_t area = 0, xmin = 0, xmax = -1, ymin = 0, ymax = -1;
        if (bh > 0 && bw > 0) {
            paste_axis(sh, bh, ay);
            paste_axis(sw, bw, ax);
            xmin = W; ymin = H;
            for (int64_t j = 0; j < bh; ++j) {
                for (int64_t i = 0; i < bw; ++i) {
                    if (!paste_support_at(m, sw, ay, ax, j, i)) continue;
                    ++area;
                    int64_t yy = y1 + j, xx = x1 + i;
                    if (xx < xmin) xmin = xx;
                    if (xx > xmax) xmax = xx;
                    if (yy < ymin) ymin = yy;
                    if (yy > ymax) ymax = yy;
                }
            }
        }
        float* t = tight_out + b * 4;
        if (area == 0) {
            t[0] = t[1] = t[2] = t[3] = 0.0f;
        } else {
            t[0] = (float)xmin;
            t[1] = (float)ymin;
            t[2] = (float)(xmax + 1);
            t[3] = (float)(ymax + 1);
        }
        area_out[b] = area;
    }
}

// RLE runs (column-major COCO order, starting with 0s) of the pasted
// support mask in the full (H, W) canvas, emitted directly: the canvas
// is never materialized. Returns the number of runs (<= H*W+1).
int64_t paste_support_rle(const uint8_t* mask, int64_t sh, int64_t sw,
                          const float* box, int64_t H, int64_t W,
                          int64_t* runs_out) {
    int64_t x1, y1, x2, y2;
    paste_box_bounds(box, H, W, x1, y1, x2, y2);
    int64_t bh = y2 - y1, bw = x2 - x1;
    PasteAxis ay, ax;
    if (bh > 0 && bw > 0) {
        paste_axis(sh, bh, ay);
        paste_axis(sw, bw, ax);
    }
    int64_t m_runs = 0, count = 0;
    uint8_t cur = 0;
    auto push = [&](uint8_t v, int64_t k) {
        if (k <= 0) return;
        if (v == cur) {
            count += k;
        } else {
            runs_out[m_runs++] = count;
            cur = v;
            count = k;
        }
    };
    for (int64_t x = 0; x < W; ++x) {
        if (bh <= 0 || bw <= 0 || x < x1 || x >= x2) {
            push(0, H);
            continue;
        }
        int64_t i = x - x1;
        push(0, y1);
        for (int64_t j = 0; j < bh; ++j)
            push(paste_support_at(mask, sw, ay, ax, j, i) ? 1 : 0, 1);
        push(0, H - y2);
    }
    runs_out[m_runs++] = count;
    return m_runs;
}

// ------------------------------------ probability paste-back (detector)
//
// The detector's 28x28 mask probabilities pasted into the full (H, W)
// image at the integer box extent and thresholded: ops/image.py's
// paste_mask_into_canvas(prob, box) > thresh, emitted as RLE runs without
// materializing the canvas. The weights are its weight matrices' (half-pixel
// positions in float64 clipped to the source, float32 weights, the two taps
// summed where they meet at the edge); rows are blended first, then
// columns, in float32. Returns the number of runs (<= H*W+1).

struct ProbAxis {
    std::vector<int32_t> lo, hi;
    std::vector<float> wlo, whi;
};

static void prob_axis(int64_t in, int64_t out, ProbAxis& ax) {
    ax.lo.resize((size_t)out);
    ax.hi.resize((size_t)out);
    ax.wlo.resize((size_t)out);
    ax.whi.resize((size_t)out);
    double scale = (double)in / (double)out;
    double lim = (double)(in - 1);
    for (int64_t j = 0; j < out; ++j) {
        double src = ((double)j + 0.5) * scale - 0.5;
        if (src < 0.0) src = 0.0;
        if (src > lim) src = lim;
        double lof = std::floor(src);
        int64_t lo = (int64_t)lof;
        int64_t hi = std::min(lo + 1, in - 1);
        float wl = (float)(1.0 - (src - lof)), wh = (float)(src - lof);
        if (hi == lo) wl += wh, wh = 0.0f;
        ax.lo[j] = (int32_t)lo;
        ax.hi[j] = (int32_t)hi;
        ax.wlo[j] = wl;
        ax.whi[j] = wh;
    }
}

int64_t paste_prob_rle(const float* prob, int64_t sh, int64_t sw, const float* box, int64_t H, int64_t W,
                       float thresh, int64_t* runs_out) {
    int64_t x1, y1, x2, y2;
    paste_box_bounds(box, H, W, x1, y1, x2, y2);
    int64_t bh = y2 - y1, bw = x2 - x1;
    ProbAxis ay, ax;
    std::vector<float> rows;  // [bh, sw]: the mask's rows blended to the box height
    if (bh > 0 && bw > 0) {
        prob_axis(sh, bh, ay);
        prob_axis(sw, bw, ax);
        rows.resize((size_t)(bh * sw));
        for (int64_t j = 0; j < bh; ++j) {
            const float* r0 = prob + (int64_t)ay.lo[j] * sw;
            const float* r1 = prob + (int64_t)ay.hi[j] * sw;
            for (int64_t c = 0; c < sw; ++c) {
                float a = ay.wlo[j] * r0[c];
                float b = ay.whi[j] * r1[c];
                rows[j * sw + c] = a + b;
            }
        }
    }
    int64_t m_runs = 0, count = 0;
    uint8_t cur = 0;
    auto push = [&](uint8_t v, int64_t k) {
        if (k <= 0) return;
        if (v == cur) {
            count += k;
        } else {
            runs_out[m_runs++] = count;
            cur = v;
            count = k;
        }
    };
    for (int64_t x = 0; x < W; ++x) {
        if (bh <= 0 || bw <= 0 || x < x1 || x >= x2) {
            push(0, H);
            continue;
        }
        int64_t i = x - x1;
        push(0, y1);
        for (int64_t j = 0; j < bh; ++j) {
            float a = rows[j * sw + ax.lo[i]] * ax.wlo[i];
            float b = rows[j * sw + ax.hi[i]] * ax.whi[i];
            push((a + b) > thresh ? 1 : 0, 1);
        }
        push(0, H - y2);
    }
    runs_out[m_runs++] = count;
    return m_runs;
}

}  // extern "C"
