// Weight-only int8 dequant-matmul (W8A16), for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/quant.py ::
// qmm_pallas (kernel body _kernel), computing for bf16 x the function the
// JAX package serves int8 weights with (its XLA qmm, ops/quant.py):
//   N > 16:  y[n, o] = sum_k x[n, k] * bf16(code[k, o] * s[k / 32, o]),
//            the dequantized weight rounded to bf16 (as _kernel drops its
//            tile to the compute dtype before the dot);
//   N <= 16: y[n, o] = sum_G s[G, o] * (sum_{k in G} x[n, k] * code[k, o]),
//            the decode form: exact codes, each group's dot in f32, the f32
//            scale applied after it.
// y is f32 and every product is exact in f32 (a bf16 times a bf16, or a
// bf16 times an int8 code). Codes are int8 [K, O], one f32 scale per group
// of 32 rows and column. The kernel picks the form from the call's N, not
// from its row tile.
//
// What bounds it on the card: bytes at decode sizes (N up to 64: each code
// byte is read once and feeds N multiply-adds), operations at prefill
// sizes. This version has no tensor cores: it runs f32 FMAs (67 TFLOP/s
// peak), so it is slow at large N; that is accepted here and recorded in
// PERF.md.
//
// Design (the first qmm4 kernel's, with one code byte a weight): a CTA of
// 64 threads owns 256 output columns (4 adjacent columns a thread, read as
// one 4-byte word of codes and one float4 of scales, so a warp reads 128
// contiguous bytes per row of K) and NT rows of x. It walks its share of
// the K groups: x rows for 4 groups are staged in shared memory as f32;
// per group a thread loads its 32 code words (the scale row changes every
// 32 rows, so one float4 of scales serves the whole group) and either
// dequantizes each code, rounds it to bf16 and uses it for all NT rows, or
// (N <= 16) sums x times the code per row and scales the group's sum. When
// the column and row tiles alone give too few CTAs to fill 132 SMs
// (decode; wk/wv at O = 1024 give 4 column tiles), K is split over
// gridDim.z; each split writes its own partial [N, O] and a second kernel
// sums the splits in a fixed order, so results do not depend on
// scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int NTHREADS = 64;
constexpr int COLS = 4;                 // columns per thread
constexpr int TILE_O = NTHREADS * COLS; // columns per CTA
constexpr int GROUP = 32;
constexpr int STAGE_GROUPS = 4;
constexpr int STAGE_K = STAGE_GROUPS * GROUP;
constexpr int DECODE_N = 16;  // ops/quant.py DECODE_N

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
qmm_kernel(const __nv_bfloat16* __restrict__ x,
           const int8_t* __restrict__ q, const float* __restrict__ s,
           float* __restrict__ part, int N, int K, int O,
           int groups_per_split) {
  __shared__ float xs[NT][STAGE_K];
  const int tid = threadIdx.x;
  const int o = (blockIdx.x * NTHREADS + tid) * COLS;
  const int n0 = blockIdx.y * NT;
  const int G = K / GROUP;
  const int g0 = blockIdx.z * groups_per_split;
  const int g1 = min(g0 + groups_per_split, G);
  const bool decode_form = N <= DECODE_N;

  float acc[NT][COLS];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[n][c] = 0.f;

  for (int gb = g0; gb < g1; gb += STAGE_GROUPS) {
    const int ng = min(STAGE_GROUPS, g1 - gb);
    __syncthreads();
    for (int idx = tid; idx < NT * STAGE_K; idx += NTHREADS) {
      const int r = idx / STAGE_K, kk = idx - r * STAGE_K;
      const int n = n0 + r;
      float val = 0.f;
      if (n < N && kk < ng * GROUP)
        val = __bfloat162float(x[(int64_t)n * K + (int64_t)gb * GROUP + kk]);
      xs[r][kk] = val;
    }
    __syncthreads();
    if (o < O) {
      for (int gi = 0; gi < ng; ++gi) {
        const int g = gb + gi;
        const float4 sc = *(const float4*)(s + (int64_t)g * O + o);
        const float scl[COLS] = {sc.x, sc.y, sc.z, sc.w};
        uint32_t words[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          words[j] = *(const uint32_t*)(q + ((int64_t)g * GROUP + j) * O + o);
        if (decode_form) {
          float gacc[NT][COLS];
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < COLS; ++c) gacc[n][c] = 0.f;
#pragma unroll
          for (int j = 0; j < GROUP; ++j) {
            float w[COLS];
#pragma unroll
            for (int c = 0; c < COLS; ++c)
              w[c] = (float)(int8_t)((words[j] >> (8 * c)) & 0xffu);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const float xv = xs[n][gi * GROUP + j];
#pragma unroll
              for (int c = 0; c < COLS; ++c)
                gacc[n][c] = fmaf(xv, w[c], gacc[n][c]);
            }
          }
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < COLS; ++c)
              acc[n][c] = fmaf(gacc[n][c], scl[c], acc[n][c]);
        } else {
#pragma unroll
          for (int j = 0; j < GROUP; ++j) {
            float w[COLS];
#pragma unroll
            for (int c = 0; c < COLS; ++c)
              w[c] = round_bf16(
                  (float)(int8_t)((words[j] >> (8 * c)) & 0xffu) * scl[c]);
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              const float xv = xs[n][gi * GROUP + j];
#pragma unroll
              for (int c = 0; c < COLS; ++c)
                acc[n][c] = fmaf(xv, w[c], acc[n][c]);
            }
          }
        }
      }
    }
  }
  if (o < O) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n0 + n < N) {
        float4 r = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
        *(float4*)(part + ((int64_t)blockIdx.z * N + n0 + n) * O + o) = r;
      }
    }
  }
}

__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, int64_t NO, int ksplit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NO) return;
  float r = part[i];
  for (int z = 1; z < ksplit; ++z) r += part[z * NO + i];
  out[i] = r;
}

template <int NT>
void launch_nt(const void* x, const void* q, const void* s, float* part,
               int N, int K, int O, int ksplit, int gps, cudaStream_t st) {
  dim3 grid((O + TILE_O - 1) / TILE_O, (N + NT - 1) / NT, ksplit);
  qmm_kernel<NT><<<grid, NTHREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)s, part, N,
      K, O, gps);
}

}  // namespace

// x [N, K] bf16, q [K, O] int8, s [K/32, O] f32 → out [N, O] f32; all
// contiguous. K % 32 == 0 and O % 4 == 0 (the wrapper checks). The row
// tile nt is one of 1, 2, 4, 8, 16. With ksplit > 1, ``work`` holds
// [ksplit, N, O] f32 partials (each split covers ``gps`` groups);
// with ksplit == 1 it is unused. Returns cudaGetLastError().
extern "C" int qmm_bf16(const void* x, const void* q, const void* s,
                        float* out, float* work, int N, int K, int O, int nt,
                        int ksplit, int gps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* part = ksplit > 1 ? work : out;
  switch (nt) {
    case 1: launch_nt<1>(x, q, s, part, N, K, O, ksplit, gps, st); break;
    case 2: launch_nt<2>(x, q, s, part, N, K, O, ksplit, gps, st); break;
    case 4: launch_nt<4>(x, q, s, part, N, K, O, ksplit, gps, st); break;
    case 8: launch_nt<8>(x, q, s, part, N, K, O, ksplit, gps, st); break;
    case 16: launch_nt<16>(x, q, s, part, N, K, O, ksplit, gps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (ksplit > 1) {
    const int64_t NO = (int64_t)N * O;
    const int threads = 256;
    sum_splits<<<(unsigned)((NO + threads - 1) / threads), threads, 0, st>>>(
        work, out, NO, ksplit);
  }
  return (int)cudaGetLastError();
}
