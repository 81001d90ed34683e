// Fused center-reasoning decode for one NVIDIA Hopper card (sm_90a).
//
// Replaces: unmore_tpu/ops/pallas/decode.py:33 (_decode_kernel, called through
// fused_center_decode at :113-157), the one Pallas kernel of the JAX package.
//
// For each crop, in one pass and with the same f32 operations in the same order
// as the plain version (ops/fields.py::center_singularity_scores of this
// package):
//   union   = sdf > 0 | cy*cy + cx*cx > 0.25                (written as int32)
//   eroded  = erode_rounds x (row min, then column min) over erode_k, zero pad
//   score   = sum over the non-zero taps (i, j) of the anti_k x anti_k
//             inward-unit kernel, row-major, acc + wy*ty + wx*tx; / (k*k - 1);
//             kept on eroded pixels, zero on a `border`-px frame
//   max, first-occurrence flat argmax of score
// Products and sums use the _rn intrinsics so that nvcc contracts nothing into
// an FMA: the kernel then gives the plain version's bits.
//
// Design: one CTA per crop. The union and the two erosion ping-pong buffers are
// uint8 in shared memory (3 x S*S bytes: 48 KiB at S=128). Center taps are read
// from device memory through L1 (each value is read by up to 48 neighbours).
// A block reduction of (score, flat index) keeps the smaller index on ties.
//
// Bound on an H100 SXM at S=128: per crop it must read 192 KiB (sdf + center)
// and write 64 KiB (union) -- 64 MiB for a 256-crop chunk, ~20 us at
// 3.35 TB/s. The arithmetic (~250 f32 ops a pixel) is below that at 67 TFLOP/s.
// This first version is simple and correct, not tuned to that bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ void keep_best(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ sdf, const float2* __restrict__ center,
              const float2* __restrict__ anti_w, float* __restrict__ max_out,
              int* __restrict__ argmax_out, int* __restrict__ union_out, int S,
              int border, int erode_k, int erode_rounds, int anti_k) {
  extern __shared__ uint8_t smem[];
  __shared__ float warp_v[kThreads / 32];
  __shared__ int warp_i[kThreads / 32];

  const int n = S * S;
  uint8_t* uni = smem;
  uint8_t* ping = smem + n;
  uint8_t* pong = smem + 2 * n;
  const size_t crop = blockIdx.x;
  const float* sdf_c = sdf + crop * n;
  const float2* cen_c = center + crop * n;
  int* uni_out = union_out + crop * n;

  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const float2 c = cen_c[p];
    const float sq = __fadd_rn(__fmul_rn(c.x, c.x), __fmul_rn(c.y, c.y));
    const int u = (sdf_c[p] > 0.0f) || (sq > 0.25f);
    uni[p] = (uint8_t)u;
    uni_out[p] = u;
  }
  __syncthreads();

  // erosion of a 0/1 mask: a min filter is an AND over the window
  const int half = erode_k / 2;
  const uint8_t* eroded = uni;
  for (int r = 0; r < erode_rounds; ++r) {
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int y = p / S, x = p - (p / S) * S;
      uint8_t m = 1;
      for (int d = -half; d <= half; ++d) {
        const int xx = x + d;
        m &= (xx >= 0 && xx < S) ? eroded[y * S + xx] : (uint8_t)0;
      }
      ping[p] = m;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int y = p / S, x = p - (p / S) * S;
      uint8_t m = 1;
      for (int d = -half; d <= half; ++d) {
        const int yy = y + d;
        m &= (yy >= 0 && yy < S) ? ping[yy * S + x] : (uint8_t)0;
      }
      pong[p] = m;
    }
    __syncthreads();
    eroded = pong;
  }

  const int ah = anti_k / 2;
  const float denom = (float)(anti_k * anti_k - 1);
  float best = -INFINITY;
  int best_i = n;
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    const int y = p / S, x = p - (p / S) * S;
    float score = 0.0f;
    if (y >= border && y < S - border && x >= border && x < S - border && eroded[p]) {
      float acc = 0.0f;
      for (int i = 0; i < anti_k; ++i) {
        const int yy = y + i - ah;
        for (int j = 0; j < anti_k; ++j) {
          const float2 w = __ldg(&anti_w[i * anti_k + j]);  // (wy, wx)
          if (w.x == 0.0f && w.y == 0.0f) continue;
          const int xx = x + j - ah;
          float2 t = make_float2(0.0f, 0.0f);
          if (yy >= 0 && yy < S && xx >= 0 && xx < S) t = __ldg(&cen_c[yy * S + xx]);
          acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(w.x, t.x)), __fmul_rn(w.y, t.y));
        }
      }
      score = __fdiv_rn(acc, denom);
    }
    keep_best(best, best_i, score, p);  // p ascends: strict > keeps the first
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
    keep_best(best, best_i, ov, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_v[warp] = best;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) keep_best(best, best_i, warp_v[w], warp_i[w]);
    max_out[crop] = best;
    argmax_out[2 * crop] = best_i / S;
    argmax_out[2 * crop + 1] = best_i % S;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success). Inputs:
// sdf [B,S,S] f32, center [B,S,S,2] f32 (dy, dx), anti_w [anti_k,anti_k,2] f32.
// Outputs: max_out [B] f32, argmax_out [B,2] int32 (y, x), union_out [B,S,S] int32.
int unmore_fused_center_decode(const float* sdf, const float* center, const float* anti_w,
                               float* max_out, int* argmax_out, int* union_out, int B, int S,
                               int border, int erode_k, int erode_rounds, int anti_k,
                               void* stream) {
  const int smem = 3 * S * S;
  cudaError_t err =
      cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    decode_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        sdf, reinterpret_cast<const float2*>(center), reinterpret_cast<const float2*>(anti_w),
        max_out, argmax_out, union_out, S, border, erode_k, erode_rounds, anti_k);
  }
  return (int)cudaGetLastError();
}

const char* unmore_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
