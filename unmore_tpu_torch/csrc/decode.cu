// Fused center-reasoning decode for one NVIDIA Hopper card (sm_90a).
//
// Replaces: unmore_tpu/ops/pallas/decode.py:33 (_decode_kernel, called through
// fused_center_decode at :113-157), the one Pallas kernel of the JAX package.
//
// For each crop, with the same f32 operations in the same order as the plain
// version (ops/fields.py::center_singularity_scores of this package):
//   union   = sdf > 0 | cy*cy + cx*cx > 0.25                (written as int32)
//   eroded  = erode_rounds x (row min, then column min) over erode_k, zero pad
//   score   = sum over the taps (i, j) of the anti_k x anti_k inward-unit
//             kernel but its zero center, row-major, acc + wy*ty + wx*tx;
//             / (k*k - 1); kept on eroded pixels, zero on a `border`-px frame
//   max, first-occurrence flat argmax of score
// Products and sums use the _rn intrinsics so that nvcc contracts nothing into
// an FMA: the kernel then gives the plain version's bits.
//
// What bounds it on an H100 SXM: bytes. Each pixel's sdf (4 B) and center
// (8 B) must be read and its union (4 B) written, 16 B a pixel: 64 MiB for a
// [256,128,128] chunk, ~20 us at 3.35 TB/s. The arithmetic, ~200 f32
// operations a scored pixel, takes a fifth of that at 67 TFLOP/s, and the
// 48-tap sum must keep its order, so tensor cores cannot take it.
//
// The design, three launches:
//  A. union_pack reads every input byte once, at full bandwidth. A warp takes
//     32 consecutive pixels of a row (coalesced sdf and float2 center loads),
//     writes their int32 union and packs the 32 union bits into one word with
//     __ballot_sync: [B, S, ceil(S/32)] words of scratch, 1/128 of the input
//     bytes, with zero bits past column S (the zero padding). It also resets
//     each crop's argmax key.
//  B. erode_score runs one CTA per (crop, band of rows), so that a 32-crop
//     chunk still fills the 132 SMs. The rounds of zero-padded k x k erosion
//     are one erosion by a box of side 2 * rounds * (k/2) + 1 (25 for the
//     engine's 9 x 3), done on packed words in shared memory over only the
//     rows the band needs: an AND of funnel-shifted words along the row, then
//     an AND over the box's rows. Only a band with eroded interior pixels
//     reads the center field again: its rows +- anti_k/2 go to shared memory
//     as planar cy and cx with a zero halo, and each thread scores a strip of
//     rows of one column, sliding down the strip so that each loaded tap row
//     serves every output it reaches. The band's best (score, index) becomes
//     one 64-bit atomicMax per CTA on its crop's key.
//  C. decode_keys turns each crop's key into its max and argmax.
// The engine's parameters (border 10, erode 9 x 3, anti 5) are compile-time
// constants of one instantiation; other odd values run a second
// instantiation of the same template with their bounds at run time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRuntime = -1;    // a template parameter taken at run time
constexpr int kPackThreads = 256;
constexpr int kPackWords = 2;   // 32-pixel words a warp of pass A packs (PERF.md)
constexpr int kScoreThreads = 128;
constexpr int kStripRows = 4;   // rows a thread scores at once (compile-time instantiation)
constexpr int kMaxAntiK = 21;   // the taps travel by value among the kernel parameters (< 4 KB)
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int N>
struct Taps {
  float2 w[N];  // (wy, wx) of tap (i, j) at i * anti_k + j
};

template <int C>
__device__ __forceinline__ int pick(int runtime) {
  return C == kRuntime ? runtime : C;
}

// (score, flat index) as one integer in the argmax's order: a larger score
// first, then the smaller index (jnp.argmax keeps the first occurrence).
__device__ __forceinline__ unsigned long long make_key(float score, int index) {
  uint32_t u = __float_as_uint(score);
  if ((u & 0x7FFFFFFFu) == 0u) u = 0u;  // -0 == +0 for the plain version's ==
  const uint32_t hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)hi << 32) | (kFull - (uint32_t)index);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(kFull - (uint32_t)key);
}

__device__ __forceinline__ unsigned long long max_key(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// Word i of a packed row, 0 outside [0, W).
__device__ __forceinline__ uint32_t word_at(const uint32_t* row, int W, int i) {
  return (i >= 0 && i < W) ? row[i] : 0u;
}

// The 32 pixels [32w + d, 32w + d + 32) of a packed row as one word, 0 outside it.
__device__ __forceinline__ uint32_t shifted(const uint32_t* row, int W, int w, int d) {
  const int q = d >> 5, r = d & 31;  // floor division and its remainder
  const uint32_t lo = word_at(row, W, w + q);
  return r == 0 ? lo : __funnelshift_r(lo, word_at(row, W, w + q + 1), r);
}

// Bits of word w that lie in columns [xs, xe).
__device__ __forceinline__ uint32_t column_mask(int w, int xs, int xe) {
  const int lo = min(max(xs - 32 * w, 0), 32), hi = min(max(xe - 32 * w, 0), 32);
  if (hi <= lo) return 0u;
  return (hi == 32 ? kFull : ((1u << hi) - 1u)) & ~((1u << lo) - 1u);
}

// Pass A: union, packed union bits, and a reset of each crop's argmax key.
__global__ void __launch_bounds__(kPackThreads)
union_pack(const float* __restrict__ sdf, const float2* __restrict__ center, int* __restrict__ union_out,
           uint32_t* __restrict__ bits, unsigned long long* __restrict__ keys, int S, int W, int n_words) {
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * (kPackThreads / 32) + (threadIdx.x >> 5)) * kPackWords;
  float s[kPackWords];
  float2 c[kPackWords];
  int pix[kPackWords];
  bool in[kPackWords];
#pragma unroll
  for (int k = 0; k < kPackWords; ++k) {  // all loads first: every word's in flight at once
    const int t = first + k;  // word index: (crop * S + row) * W + word
    const int row = t / W;
    const int x = (t - row * W) * 32 + lane;
    in[k] = t < n_words && x < S;
    pix[k] = row * S + x;
    s[k] = 0.0f;
    c[k] = make_float2(0.0f, 0.0f);
    if (in[k]) {
      s[k] = __ldg(sdf + pix[k]);
      c[k] = __ldg(center + pix[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPackWords; ++k) {
    const int t = first + k;
    const float sq = __fadd_rn(__fmul_rn(c[k].x, c[k].x), __fmul_rn(c[k].y, c[k].y));
    const bool u = in[k] && (s[k] > 0.0f || sq > 0.25f);
    if (in[k]) union_out[pix[k]] = u;
    const uint32_t word = __ballot_sync(kFull, u);
    if (lane == 0 && t < n_words) {
      bits[t] = word;
      if (t % (S * W) == 0) keys[t / (S * W)] = 0ull;
    }
  }
}

// Scores of V rows of column x, from planar taps staged at [row][col + ah]:
// output v is pixel (row0 + v, x) of the staging, tap (i, j) at row0 + v + i,
// col x + j. Each output sums its taps in row-major order.
template <int AK, int V, int NT>
__device__ __forceinline__ void strip_scores(const float* cy, const float* cx, int P, int row0, int x, int K,
                                             const Taps<NT>& taps, float (&out)[V]) {
  if constexpr (AK != kRuntime) {
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int r = 0; r < V + AK - 1; ++r) {  // each staged row is loaded once
      float ty[AK], tx[AK];
#pragma unroll
      for (int j = 0; j < AK; ++j) {
        ty[j] = cy[(row0 + r) * P + x + j];
        tx[j] = cx[(row0 + r) * P + x + j];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = r - v;  // the tap row that staged row r is for output v
        if (i < 0 || i >= AK) continue;
#pragma unroll
        for (int j = 0; j < AK; ++j) {
          if (i == AK / 2 && j == AK / 2) continue;
          const float2 w = taps.w[i * AK + j];
          acc[v] = __fadd_rn(__fadd_rn(acc[v], __fmul_rn(w.x, ty[j])), __fmul_rn(w.y, tx[j]));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = __fdiv_rn(acc[v], (float)(AK * AK - 1));
  } else {
    static_assert(V == 1, "the run-time instantiation scores one pixel at a time");
    float acc = 0.0f;
    for (int i = 0; i < K; ++i) {
      for (int j = 0; j < K; ++j) {
        if (i == K / 2 && j == K / 2) continue;
        const float2 w = taps.w[i * K + j];
        const int o = (row0 + i) * P + x + j;
        acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(w.x, cy[o])), __fmul_rn(w.y, cx[o]));
      }
    }
    out[0] = __fdiv_rn(acc, (float)(K * K - 1));
  }
}

// Pass B: one CTA per (crop, band of `band_rows` rows); blockIdx.x = crop * n_bands + band.
template <int BORDER, int EK, int ER, int AK, int V, int NT>
__global__ void __launch_bounds__(kScoreThreads)
erode_score(const float2* __restrict__ center, const uint32_t* __restrict__ bits,
            unsigned long long* __restrict__ keys, int S, int border_rt, int erode_k_rt, int rounds_rt,
            int anti_k_rt, int band_rows, int n_bands, const Taps<NT> taps) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned long long warp_best[kScoreThreads / 32];
  const int border = pick<BORDER>(border_rt), K = pick<AK>(anti_k_rt), ah = K / 2;
  // `rounds` zero-padded k x k erosions of a 0/1 mask are one zero-padded
  // erosion by a box of side 2H + 1: an AND over that window
  const int H = pick<ER>(rounds_rt) * (pick<EK>(erode_k_rt) / 2);
  const int W = (S + 31) >> 5, n_words = S * W;
  const int crop = blockIdx.x / n_bands, band = blockIdx.x - crop * n_bands;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = S + 2 * ah;  // staged row pitch
  uint32_t* mask = smem;           // [S][W] union, then eroded, by absolute row
  uint32_t* tmp = smem + n_words;  // [S][W] after the row pass
  float* cy = reinterpret_cast<float*>(smem + 2 * n_words);  // [band_rows + 2ah][P]
  float* cx = cy + (band_rows + 2 * ah) * P;

  // this band's interior: rows [ys, ye), columns [xs, xe)
  const int lo = max(border, 0), hi = min(S - border, S);
  const int r0 = band * band_rows;
  const int ys = max(r0, lo), ye = min(min(r0 + band_rows, S), hi), xs = lo, xe = hi;
  bool any = false;
  if (ys < ye && xs < xe) {
    // the row pass needs the union's rows [ls, le); the column pass yields [ys, ye)
    const int ls = max(ys - H, 0), le = min(ye + H, S);
    const uint32_t* crop_bits = bits + (size_t)crop * n_words;
    for (int i = ls * W + tid; i < le * W; i += kScoreThreads) mask[i] = crop_bits[i];
    __syncthreads();
    for (int i = ls * W + tid; i < le * W; i += kScoreThreads) {
      const int y = i / W, w = i - y * W;
      uint32_t m = kFull;
#pragma unroll
      for (int d = -H; d <= H; ++d) m &= shifted(mask + y * W, W, w, d);
      tmp[i] = m;
    }
    __syncthreads();
    for (int i = ys * W + tid; i < ye * W; i += kScoreThreads) {
      const int y = i / W, w = i - y * W;
      uint32_t m = kFull;
#pragma unroll
      for (int d = -H; d <= H; ++d) m &= (y + d >= 0 && y + d < S) ? tmp[i + d * W] : 0u;
      mask[i] = m;
      any |= (m & column_mask(w, xs, xe)) != 0u;
    }
  }
  any = __syncthreads_or(any);

  // Pixel (r0, 0) scores exactly 0 and precedes every other pixel of the band
  // whenever column 0 lies in the border; with no border, every pixel of the
  // band takes part, the unscored ones with 0.
  const bool every_pixel = lo == 0;
  unsigned long long best = (every_pixel && any) ? 0ull : make_key(0.0f, r0 * S);
  if (any) {
    const int n_strips = (ye - ys + V - 1) / V;
    const int rows = n_strips * V + 2 * ah;
    for (int r = warp; r < rows; r += kScoreThreads / 32) {
      const int y = ys - ah + r;
      const bool row_in = y >= 0 && y < S && y < ye + ah;
      for (int c = lane; c < P; c += 32) {
        const int x = c - ah;
        float2 t = make_float2(0.0f, 0.0f);
        if (row_in && x >= 0 && x < S) t = __ldg(center + ((size_t)crop * S + y) * S + x);
        cy[r * P + c] = t.x;
        cx[r * P + c] = t.y;
      }
    }
    __syncthreads();
    const int n_cols = xe - xs;
    for (int it = tid; it < n_strips * n_cols; it += kScoreThreads) {
      const int s = it / n_cols, x = xs + (it - s * n_cols), y0 = ys + s * V;
      uint32_t on = 0u;  // bit v: pixel (y0 + v, x) is eroded
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (y0 + v < ye) on |= ((mask[(y0 + v) * W + (x >> 5)] >> (x & 31)) & 1u) << v;
      }
      if (on == 0u && !every_pixel) continue;
      float sc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) sc[v] = 0.0f;
      if (on != 0u) strip_scores<AK, V, NT>(cy, cx, P, s * V, x, K, taps, sc);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (y0 + v < ye && (every_pixel || ((on >> v) & 1u))) {
          best = max_key(best, make_key(((on >> v) & 1u) ? sc[v] : 0.0f, (y0 + v) * S + x));
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = max_key(best, __shfl_xor_sync(kFull, best, off));
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kScoreThreads / 32; ++w) best = max_key(best, warp_best[w]);
    atomicMax(&keys[crop], best);
  }
}

// Pass C: each crop's key into its max and (y, x) argmax.
__global__ void decode_keys(const unsigned long long* __restrict__ keys, float* __restrict__ max_out,
                            int* __restrict__ argmax_out, int B, int S) {
  const int crop = blockIdx.x * blockDim.x + threadIdx.x;
  if (crop >= B) return;
  const unsigned long long key = keys[crop];
  const int idx = key_index(key);
  max_out[crop] = key_score(key);
  argmax_out[2 * crop] = idx / S;
  argmax_out[2 * crop + 1] = idx % S;
}

constexpr int kTapsFixed = 5 * 5;
constexpr int kTapsRuntime = kMaxAntiK * kMaxAntiK;
// the engine's parameters (border 10, erode 9 x 3, anti 5) at compile time, and the rest
#define UNMORE_SCORE_FIXED erode_score<10, 9, 3, 5, kStripRows, kTapsFixed>
#define UNMORE_SCORE_GENERAL erode_score<kRuntime, kRuntime, kRuntime, kRuntime, 1, kTapsRuntime>

template <int N>
Taps<N> load_taps(const float* anti_w, int anti_k) {
  Taps<N> t = {};
  for (int i = 0; i < anti_k * anti_k; ++i) t.w[i] = make_float2(anti_w[2 * i], anti_w[2 * i + 1]);
  return t;
}

template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int max_smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              max_smem - (int)attr.sharedSizeBytes);
}

}  // namespace

extern "C" {

// Raises the scoring pass's dynamic shared-memory limit to what a block may
// use on the current device beside the kernel's static shared memory; call
// once per device before its first decode.
int unmore_decode_init() {
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = raise_smem_limit(UNMORE_SCORE_FIXED, max_smem);
  if (err == cudaSuccess) err = raise_smem_limit(UNMORE_SCORE_GENERAL, max_smem);
  return (int)err;
}

// Three launches on `stream`; returns cudaGetLastError() (0 on success).
// Inputs: sdf [B,S,S] f32, center [B,S,S,2] f32 (dy, dx) on the device;
// anti_w [anti_k,anti_k,2] f32 (wy, wx) in host memory, anti_k <= 21.
// Outputs: max_out [B] f32, argmax_out [B,2] int32 (y, x), union_out
// [B,S,S] int32. workspace: B keys (u64), then B*S*ceil(S/32) words (u32)
// of packed bits. B*S*S < 2^31. The scoring pass runs n_bands CTAs of
// band_rows rows (a multiple of 4) per crop with smem_bytes of dynamic
// shared memory, as ops/decode.py computes them.
int unmore_fused_center_decode(const float* sdf, const float* center, const float* anti_w, float* max_out,
                               int* argmax_out, int* union_out, void* workspace, int B, int S, int border,
                               int erode_k, int erode_rounds, int anti_k, int band_rows, int n_bands,
                               int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  if (anti_k > kMaxAntiK || band_rows % kStripRows != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* keys = static_cast<unsigned long long*>(workspace);
  auto* bits = reinterpret_cast<uint32_t*>(keys + B);
  const auto* cen = reinterpret_cast<const float2*>(center);
  const int W = (S + 31) / 32, n_words = B * S * W;
  const int words_per_block = (kPackThreads / 32) * kPackWords;
  union_pack<<<(n_words + words_per_block - 1) / words_per_block, kPackThreads, 0, st>>>(
      sdf, cen, union_out, bits, keys, S, W, n_words);
  const int grid = B * n_bands;
  if (border == 10 && erode_k == 9 && erode_rounds == 3 && anti_k == 5) {
    UNMORE_SCORE_FIXED<<<grid, kScoreThreads, smem_bytes, st>>>(
        cen, bits, keys, S, border, erode_k, erode_rounds, anti_k, band_rows, n_bands,
        load_taps<kTapsFixed>(anti_w, anti_k));
  } else {
    UNMORE_SCORE_GENERAL<<<grid, kScoreThreads, smem_bytes, st>>>(
        cen, bits, keys, S, border, erode_k, erode_rounds, anti_k, band_rows, n_bands,
        load_taps<kTapsRuntime>(anti_w, anti_k));
  }
  decode_keys<<<(B + 255) / 256, 256, 0, st>>>(keys, max_out, argmax_out, B, S);
  return (int)cudaGetLastError();
}

const char* unmore_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
