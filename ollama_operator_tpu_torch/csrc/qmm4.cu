// Weight-only int4 dequant-matmul (W4A16), for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/quant.py ::
// qmm4_pallas (kernel body _kernel4). Same function:
//   y[n, o] = sum_k x[n, k] * (code[k, o] * s[k / 32, o]),  y in f32,
// with int4 codes packed group-locally (ops/quant.py): within each group of
// 32 rows, byte j of the group holds row j in its low nibble and row j + 16
// in its high nibble, both biased by +8.
//
// What bounds it on the card: bytes at decode sizes (N up to 64: each
// packed byte is read once and feeds only 2N multiply-adds), operations at
// prefill sizes. This first version has no tensor cores: it runs f32 FMAs
// (67 TFLOP/s peak), so it is slow at large N; that is accepted here and
// recorded in PERF.md.
//
// Design: a CTA of 64 threads owns 256 output columns (4 adjacent columns a
// thread, read as one 4-byte word of packed codes and one float4 of scales,
// so a warp reads 128 contiguous bytes per packed row) and NT rows of x.
// It walks its share of the K groups: x rows for 4 groups are staged in
// shared memory as f32, each packed byte is read from device memory once,
// unpacked to its two rows with -8, scaled by the f32 group scale and used
// for all NT rows. When the column and row tiles alone give too few CTAs to
// fill 132 SMs (decode), K is split over gridDim.z; each split writes its
// own partial [N, O] and a second kernel sums the splits in a fixed order,
// so results do not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 64;
constexpr int COLS = 4;                 // columns per thread
constexpr int TILE_O = NTHREADS * COLS; // columns per CTA
constexpr int GROUP = 32;
constexpr int STAGE_GROUPS = 4;
constexpr int STAGE_K = STAGE_GROUPS * GROUP;

template <int NT>
__global__ void __launch_bounds__(NTHREADS)
qmm4_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ q4, const float* __restrict__ s,
            float* __restrict__ part, int N, int K, int O,
            int groups_per_split) {
  __shared__ float xs[NT][STAGE_K];
  const int tid = threadIdx.x;
  const int o = (blockIdx.x * NTHREADS + tid) * COLS;
  const int n0 = blockIdx.y * NT;
  const int G = K / GROUP;
  const int g0 = blockIdx.z * groups_per_split;
  const int g1 = min(g0 + groups_per_split, G);

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
        uint32_t words[GROUP / 2];
#pragma unroll
        for (int j = 0; j < GROUP / 2; ++j)
          words[j] = *(const uint32_t*)(q4 + ((int64_t)g * (GROUP / 2) + j) * O + o);
#pragma unroll
        for (int j = 0; j < GROUP / 2; ++j) {
          float wlo[COLS], whi[COLS];
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const uint32_t byte = (words[j] >> (8 * c)) & 0xffu;
            wlo[c] = (float)((int)(byte & 0xfu) - 8) * scl[c];
            whi[c] = (float)((int)(byte >> 4) - 8) * scl[c];
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float xlo = xs[n][gi * GROUP + j];
            const float xhi = xs[n][gi * GROUP + j + GROUP / 2];
#pragma unroll
            for (int c = 0; c < COLS; ++c) {
              acc[n][c] = fmaf(xlo, wlo[c], acc[n][c]);
              acc[n][c] = fmaf(xhi, whi[c], acc[n][c]);
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
void launch_nt(const void* x, const void* q4, const void* s, float* part,
               int N, int K, int O, int ksplit, int gps, cudaStream_t st) {
  dim3 grid((O + TILE_O - 1) / TILE_O, (N + NT - 1) / NT, ksplit);
  qmm4_kernel<NT><<<grid, NTHREADS, 0, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)q4, (const float*)s, part, N,
      K, O, gps);
}

}  // namespace

// x [N, K] bf16, q4 [K/2, O] uint8, s [K/32, O] f32 → out [N, O] f32; all
// contiguous. K % 32 == 0 and O % 4 == 0 (the wrapper checks). The row
// tile nt is one of 1, 2, 4, 8, 16. With ksplit > 1, ``work`` holds
// [ksplit, N, O] f32 partials (each split covers ``gps`` groups);
// with ksplit == 1 it is unused. Returns cudaGetLastError().
extern "C" int qmm4_bf16(const void* x, const void* q4, const void* s,
                         float* out, float* work, int N, int K, int O, int nt,
                         int ksplit, int gps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* part = ksplit > 1 ? work : out;
  switch (nt) {
    case 1: launch_nt<1>(x, q4, s, part, N, K, O, ksplit, gps, st); break;
    case 2: launch_nt<2>(x, q4, s, part, N, K, O, ksplit, gps, st); break;
    case 4: launch_nt<4>(x, q4, s, part, N, K, O, ksplit, gps, st); break;
    case 8: launch_nt<8>(x, q4, s, part, N, K, O, ksplit, gps, st); break;
    case 16: launch_nt<16>(x, q4, s, part, N, K, O, ksplit, gps, st); break;
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
