// cocoeval: host library of the port's COCO evaluator
// (unmore_tpu_torch/evaluation/coco_eval.py), a copy of the COCOeval parts
// of the repository's cpp/unmore_native.cpp: the COCO counts-string
// decoder, mask IoU over run-length encodings without decoding to bitmaps,
// and the greedy detection-to-GT matching of COCOeval.evaluateImg over
// every IoU threshold. Host code, not a device kernel: evaluation runs on
// the CPU after inference, as it does in the JAX package. Plain C
// interface, built with g++ and loaded with ctypes by
// unmore_tpu_torch/ops/cocoeval.py, which holds the plain numpy versions.
//
// RLE runs are column-major (Fortran) order per the COCO spec, starting
// with a (possibly empty) run of 0s.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// IoU of two run-length masks by a merge walk over the flat F-order axis.
// crowd != 0: the denominator is the area of a alone.
double rle_iou_pair(const int64_t* ra, int64_t na, const int64_t* rb, int64_t nb, int crowd) {
    int64_t ia = 0, ib = 0;
    int64_t ca = na ? ra[0] : 0, cb = nb ? rb[0] : 0;
    uint8_t va = 0, vb = 0;
    int64_t inter = 0, area_a = 0, area_b = 0;
    while (ia < na && ib < nb) {
        int64_t step = std::min(ca, cb);
        if (va && vb) inter += step;
        if (va) area_a += step;
        if (vb) area_b += step;
        ca -= step;
        cb -= step;
        if (ca == 0) {
            ++ia;
            if (ia < na) { ca = ra[ia]; va ^= 1; }
        }
        if (cb == 0) {
            ++ib;
            if (ib < nb) { cb = rb[ib]; vb ^= 1; }
        }
    }
    // the tail of the longer list
    while (ia < na) { if (va) area_a += ca; ++ia; if (ia < na) { ca = ra[ia]; va ^= 1; } }
    while (ib < nb) { if (vb) area_b += cb; ++ib; if (ib < nb) { cb = rb[ib]; vb ^= 1; } }
    double denom = crowd ? (double)area_a : (double)(area_a + area_b - inter);
    return denom > 0 ? (double)inter / denom : 0.0;
}

}  // namespace

extern "C" {

// COCO counts string -> runs. Returns the number of runs (<= len).
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
                if (c & 0x10) x |= ~((int64_t)0) << (5 * (k + 1));  // sign extension
                break;
            }
            ++k;
        }
        if (m > 2) x += runs_out[m - 2];
        runs_out[m++] = x;
    }
    return m;
}

// IoU matrix [na, nb] (row-major) of two lists of run-length masks. Mask i
// of a is runs_a[offs_a[i] : offs_a[i + 1]], likewise for b; crowd[j] != 0
// makes column j use the area of the a mask as the denominator.
void rle_iou_matrix(const int64_t* runs_a, const int64_t* offs_a, int64_t na, const int64_t* runs_b,
                    const int64_t* offs_b, int64_t nb, const int32_t* crowd, double* out) {
    for (int64_t i = 0; i < na; ++i)
        for (int64_t j = 0; j < nb; ++j)
            out[i * nb + j] = rle_iou_pair(runs_a + offs_a[i], offs_a[i + 1] - offs_a[i], runs_b + offs_b[j],
                                           offs_b[j + 1] - offs_b[j], crowd[j]);
}

// Greedy detection<->GT matching of one (image, category) cell over all T
// IoU thresholds (pycocotools COCOeval.evaluateImg). The caller sorts the
// detections by descending score (capped at maxDet) and the GTs with the
// ignored ones last; ious is [D, G] row-major.
//   dtm_out   [T, D]: 1 where the detection matched (zeroed by the caller)
//   dt_ig_out [T, D]: 1 where it matched an ignored GT (zeroed by the caller)
// A crowd GT may match several detections; once a real (not ignored) GT is
// held, an ignored one cannot displace it.
void coco_match(const double* ious, int64_t D, int64_t G, const int32_t* gt_ig, const int32_t* iscrowd,
                const double* thrs, int64_t T, int64_t* dtm_out, double* dt_ig_out) {
    std::vector<int64_t> gtm((size_t)G);
    for (int64_t t = 0; t < T; ++t) {
        std::fill(gtm.begin(), gtm.end(), 0);
        for (int64_t i = 0; i < D; ++i) {
            double best = std::min(thrs[t], 1.0 - 1e-10);
            int64_t m = -1;
            for (int64_t j = 0; j < G; ++j) {
                if (gtm[j] > 0 && !iscrowd[j]) continue;
                if (m > -1 && gt_ig[m] == 0 && gt_ig[j] == 1) break;
                double v = ious[i * G + j];
                if (v < best) continue;
                best = v;
                m = j;
            }
            if (m == -1) continue;
            dt_ig_out[t * D + i] = (double)gt_ig[m];
            dtm_out[t * D + i] = 1;
            gtm[m] = 1;
        }
    }
}

}  // extern "C"
