// Causal GQA flash-attention over a fresh prefill chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/flash.py ::
// flash_prefill (kernel body _prefill_kernel). Same function: query i of the
// chunk attends keys j <= i (positions local to the chunk), optionally only
// inside a sliding window, with an optional tanh softcap on the scores, an
// f32 online softmax (the probabilities rounded to bf16 before the p . v
// product, their sum l taken unrounded), and the output in the input type.
//
// What bounds it on the card: operations. A T-token chunk does about
// 2 * H * T^2 * hd multiply-adds (half of them skipped by causality), and
// this first version runs them as plain f32 FMAs (67 TFLOP/s peak), not on
// the tensor cores (989 TFLOP/s in bf16). K/V tiles are read once per
// 64-row query tile, so bytes are far below the operation bound.
//
// Design: one CTA of 128 threads per (64-row query tile, query head, batch
// row). The CTA stages its Q tile once in shared memory (f32), then walks
// 32-key K/V tiles from the first tile the window can reach to the tile
// holding the diagonal; tiles above the diagonal or wholly outside the
// window are never loaded. Thread t owns rows 4*(t/8) .. +3 and key columns
// (t%8) + 8j of the score tile, and the same rows with output columns
// (t%8) + 8c of the accumulator; the 8 threads that share a row are lanes of
// one warp, so row max and row sum are three xor-shuffles. Shared rows are
// padded by one word so the column walks hit distinct banks. Query rows past
// T (a ragged last tile) are computed on zeros and never stored; keys past T
// are masked. GQA reads K/V of head h / (H / KvH) and never copies them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int NTHREADS = 128;
constexpr int MAX_HD = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float group8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

__global__ void __launch_bounds__(NTHREADS)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int T, int H, int KvH,
                     int hd, float scale, float softcap, int window) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;              // [BQ][hd + 1]
  float* Ks = Qs + BQ * ld;      // [BK][hd + 1]
  float* Vs = Ks + BK * ld;      // [BK][hd]
  float* Ps = Vs + BK * hd;      // [BQ][BK + 1]
  const int ldp = BK + 1;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KvH);
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const int ncol = hd / 8;

  for (int idx = tid; idx < BQ * hd; idx += NTHREADS) {
    const int r = idx / hd, d = idx - r * hd;
    const int qi = q0 + r;
    float val = 0.f;
    if (qi < T) val = __bfloat162float(q[(((int64_t)b * T + qi) * H + h) * hd + d]);
    Qs[r * ld + d] = val;
  }

  float m[4], l[4], acc[4][MAX_HD / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_HD / 8; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BQ, T) - 1;
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    if (lo > 0) k_begin = (lo / BK) * BK;
  }
  const int64_t kv_row0 = ((int64_t)b * KvH + kvh) * T;

  for (int k0 = k_begin; k0 <= q_last; k0 += BK) {
    __syncthreads();  // Q staged (first pass) / previous tile consumed
    for (int idx = tid; idx < BK * hd; idx += NTHREADS) {
      const int r = idx / hd, d = idx - r * hd;
      const int kk = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kk < T) {
        const int64_t off = (kv_row0 + kk) * hd + d;
        kv = __bfloat162float(k[off]);
        vv = __bfloat162float(v[off]);
      }
      Ks[r * ld + d] = kv;
      Vs[r * hd + d] = vv;
    }
    __syncthreads();

    float s[4][BK / 8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[BK / 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) kv[j] = Ks[(cg + 8 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int kk = k0 + cg + 8 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = (kk <= qi) && (kk < T);
        if (window > 0) ok = ok && (kk > qi - window);
        s[i][j] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        // rows with no live key yet keep m == NEG_INF: gate p so masked
        // NEG_INF scores do not turn into exp(0) = 1
        const float p = (m_new > NEG_INF * 0.5f) ? expf(s[i][j] - m_new) : 0.f;
        // p . v takes p rounded to bf16, as the TPU kernel's bf16 dot does;
        // the sum l takes it unrounded
        Ps[(rg * 4 + i) * ldp + cg + 8 * j] =
            __bfloat162float(__float2bfloat16(p));
        psum += p;
      }
      psum = group8_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < MAX_HD / 8; ++c) acc[i][c] *= alpha;
    }
    __syncwarp();  // the 8 lanes sharing a row wrote its P entries

    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(rg * 4 + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < MAX_HD / 8; ++c) {
        if (c < ncol) {
          const float vv = Vs[kk * hd + cg + 8 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= T) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + (((int64_t)b * T + qi) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < MAX_HD / 8; ++c)
      if (c < ncol) o[cg + 8 * c] = __float2bfloat16(acc[i][c] * inv);
  }
}

}  // namespace

// q [B, T, H, hd], k/v head-first [B, KvH, T, hd], out [B, T, H, hd]; all
// bf16 and contiguous. hd must be a multiple of 8 and at most 128, and
// H a multiple of KvH (the wrapper checks). Returns cudaGetLastError().
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int B, int T, int H, int KvH,
                                  int hd, float scale, float softcap,
                                  int window, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * (hd + 1) + (size_t)BK * (hd + 1) +
                       (size_t)BK * hd + (size_t)BQ * (BK + 1));
  cudaFuncSetAttribute(flash_prefill_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_prefill_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, T, H, KvH, hd, scale,
      softcap, window);
  return (int)cudaGetLastError();
}
