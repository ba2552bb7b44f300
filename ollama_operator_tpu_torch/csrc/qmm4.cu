// Weight-only int4 dequant-matmul (W4A16), for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/quant.py ::
// qmm4_pallas (kernel body _kernel4). Same function for bf16 x:
//   y[n, o] = sum_k x[n, k] * bf16(code[k, o] * s[k / 32, o]),  y in f32,
// i.e. code * s is taken in f32 and rounded to the nearest bf16 (as
// _kernel4 drops its tile to the compute dtype before the dot), every
// product is exact (a bf16 times a bf16) and the sums are f32. int4 codes
// are packed group-locally (ops/quant.py): within each group of 32 rows,
// byte j of the group holds row j in its low nibble and row j + 16 in its
// high nibble, both biased by +8.
//
// What bounds it on the card: bytes at decode sizes (at N = 64 the w_gate
// call moves 40.9 MB, most of it codes and f32 scales, 12.2 us at
// 3.35 TB/s, for 7.5 GFLOP), operations at prefill sizes (N = 512:
// 60 GFLOP, 0.061 ms at 989 TFLOP/s).
//
// Design: bf16 tensor cores (mma.sync.m16n8k16, f32 accumulation) fed by a
// multi-stage cp.async pipeline. A CTA of 8 warps owns 256 output columns
// and up to MT 16-row tiles of x (MT = 1 at N <= 16, 2 at N <= 32, else 4;
// rows past N are zero-filled). A pipeline step holds two K groups, each
// with its 16 packed rows of codes (16-byte chunks of rows of O contiguous
// bytes, padded so the fragment reads are free of bank conflicts), its row
// of f32 scales and its x tile; every thread copies the same chunks of every
// group, from addresses computed once. Three steps (six groups) are in
// flight while one computes. Warps split the columns, not the rows: warp w
// owns columns 32w .. 32w + 31 of the tile as 4 n8 tiles, lane (g, t)
// holding column 4g + c of n-tile c, so the 4 bytes a lane reads (packed
// rows 2t, 2t + 1, 2t + 8, 2t + 9, one 32-bit word each for its 4 columns)
// give it its B fragments for both k16 steps of the group: low nibbles for
// rows 0-15, high nibbles for rows 16-31. A nibble becomes a float with one
// byte permute into 2^23's mantissa and one subtraction, is multiplied by
// the f32 scale and rounded in pairs to bf16; each weight is dequantized
// once per CTA and its fragment feeds every 16-row tile. x is the A operand,
// read with ldmatrix. In that layout a lane's accumulators cover 8 adjacent
// output columns, written as two float4. When the column and row tiles alone
// leave the card underfilled (decode), K is split over gridDim.z, as far as
// the CTAs still fit one wave of two per SM; each split writes its own
// partial [N, O] and a second kernel sums the splits in a fixed order (no
// float atomics), so a repeated call gives identical results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 32;
constexpr int TILE_O = 256;           // columns per CTA, 32 per warp
constexpr int NTHREADS = 256;
constexpr int SG = 2;                 // K groups a pipeline step
constexpr int STAGES = 4;             // pipeline steps in shared memory
constexpr int CODE_LD = TILE_O + 16;  // bytes per packed row in shared memory
constexpr int X_LD = GROUP + 8;       // bf16 per x row in shared memory

template <int MT>
struct Stage {
  uint8_t codes[GROUP / 2][CODE_LD];
  float scales[TILE_O];
  __nv_bfloat16 x[MT * 16][X_LD];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a . b, one 16x8x16 bf16 tile with f32 accumulation (registers
// only, so not volatile: the compiler may schedule it among other work)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the code in the low nibble of byte c of w (already masked to nibbles),
// minus the +8 bias, times the f32 scale: byte c goes into the mantissa of
// 2^23, and 2^23 + 8 comes off exactly
__device__ __forceinline__ float dequant(uint32_t w, int c, float scale) {
  const float f = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | c));
  return (f - 8388616.f) * scale;
}

// two weights (k and k + 1 of one column) -> a bf16 pair, each rounded to
// nearest; k in the low half, as the B fragment takes them
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int MT>
__global__ void __launch_bounds__(NTHREADS)
qmm4_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ q4, const float* __restrict__ s,
            float* __restrict__ part, int N, int K, int O,
            int groups_per_split) {
  static_assert((GROUP / 2) * (TILE_O / 16) == NTHREADS,
                "one 16-byte chunk of codes a thread per group");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Stage<MT>* stages = reinterpret_cast<const Stage<MT>*>(smem_raw);
  const uint32_t smem0 = smem_u32(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int o_tile = blockIdx.x * TILE_O;
  const int n0 = blockIdx.y * MT * 16;
  const int g0 = blockIdx.z * groups_per_split;
  const int ng = min(groups_per_split, K / GROUP - g0);

  // this thread's copies, the same in every group: one 16-byte chunk of
  // codes, one of scales (tid < TILE_O / 4) and one of x (tid < MT * 64);
  // chunks past O or rows past N are zero-filled from a clamped address
  const int cr = tid / (TILE_O / 16), ccol = (tid % (TILE_O / 16)) * 16;
  const uint32_t c_dst = cr * CODE_LD + ccol;
  const uint8_t* c_src =
      q4 + ((int64_t)g0 * (GROUP / 2) + cr) * O + min(o_tile + ccol, O - 16);
  const int c_n = o_tile + ccol < O ? 16 : 0;
  const uint32_t s_dst = (GROUP / 2) * CODE_LD + 16 * tid;
  const float* s_src = s + (int64_t)g0 * O + min(o_tile + 4 * tid, O - 4);
  const int s_n = o_tile + 4 * tid < O ? 16 : 0;
  const int xr = tid / (GROUP / 8), xcol = (tid % (GROUP / 8)) * 8;
  const uint32_t x_dst =
      (GROUP / 2) * CODE_LD + 4 * TILE_O + 2 * (xr * X_LD + xcol);
  const __nv_bfloat16* x_src =
      x + (int64_t)min(n0 + xr, N - 1) * K + g0 * GROUP + xcol;
  const int x_n = n0 + xr < N ? 16 : 0;
  const int64_t c_step = (int64_t)(GROUP / 2) * O;

  auto load = [&](int gi, int slot) {  // group g0 + gi into slot
    const uint32_t base = smem0 + slot * (uint32_t)sizeof(Stage<MT>);
    cp_async16(base + c_dst, c_src + gi * c_step, c_n);
    if (tid < TILE_O / 4) cp_async16(base + s_dst, s_src + (int64_t)gi * O, s_n);
    if (tid < MT * 64) cp_async16(base + x_dst, x_src + gi * GROUP, x_n);
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;

  // a step is SG groups; STAGES - 1 steps are in flight while one computes
  const int nsteps = (ng + SG - 1) / SG;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
#pragma unroll
    for (int j = 0; j < SG; ++j)
      if (i * SG + j < ng) load(i * SG + j, i * SG + j);
    cp_async_commit();
  }

  const int wc = warp * 32 + 4 * g;  // this lane's 4 columns in the tile
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 2>();  // step i has landed
    __syncthreads();              // ... for every thread; step i - 1 is free
    const int nx = i + STAGES - 1;
#pragma unroll
    for (int j = 0; j < SG; ++j)
      if (nx * SG + j < ng) load(nx * SG + j, (nx % STAGES) * SG + j);
    cp_async_commit();

#pragma unroll
    for (int j = 0; j < SG; ++j) {
      if (i * SG + j >= ng) break;
      const Stage<MT>& S = stages[(i % STAGES) * SG + j];
      const uint32_t w[4] = {
          *reinterpret_cast<const uint32_t*>(&S.codes[2 * t4][wc]),
          *reinterpret_cast<const uint32_t*>(&S.codes[2 * t4 + 1][wc]),
          *reinterpret_cast<const uint32_t*>(&S.codes[2 * t4 + 8][wc]),
          *reinterpret_cast<const uint32_t*>(&S.codes[2 * t4 + 9][wc])};
      const float4 sc4 = *reinterpret_cast<const float4*>(&S.scales[wc]);
      const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
      // bf[k16 step][n-tile][b0, b1]: step 0 takes the low nibbles (rows
      // 0-15 of the group), step 1 the high ones (rows 16-31)
      uint32_t bf[2][4][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t nib[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          nib[r] = (w[r] >> (4 * half)) & 0x0F0F0F0Fu;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          bf[half][c][0] = pack_bf16(dequant(nib[0], c, sc[c]),
                                     dequant(nib[1], c, sc[c]));
          bf[half][c][1] = pack_bf16(dequant(nib[2], c, sc[c]),
                                     dequant(nib[3], c, sc[c]));
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(&S.x[m * 16 + (lane & 15)]
                                      [half * 16 + (lane >> 4) * 8]));
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mma_bf16(acc[m][c], a, bf[half][c][0], bf[half][c][1]);
        }
      }
    }
  }

  // accumulator (row g or g + 8, n8 column 2t + e) of n-tile c is output
  // column 32w + 4 * (2t + e) + c: a lane holds columns 8t .. 8t + 7
  float* dst = part + (int64_t)blockIdx.z * N * O;
  const int o = o_tile + warp * 32 + 8 * t4;
  if (o < O) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + m * 16 + g + 8 * r;
        if (n < N) {
          float* p = dst + (int64_t)n * O + o;
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[m][0][2 * r], acc[m][1][2 * r],
                          acc[m][2][2 * r], acc[m][3][2 * r]);
          *reinterpret_cast<float4*>(p + 4) =
              make_float4(acc[m][0][2 * r + 1], acc[m][1][2 * r + 1],
                          acc[m][2][2 * r + 1], acc[m][3][2 * r + 1]);
        }
      }
    }
  }
}

// out = sum of the ksplit partials, in split order, four floats a thread
__global__ void sum_splits(const float4* __restrict__ part,
                           float4* __restrict__ out, int64_t NO4,
                           int ksplit) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NO4) return;
  float4 r = part[i];
  for (int z = 1; z < ksplit; ++z) {
    const float4 p = part[z * NO4 + i];
    r.x += p.x;
    r.y += p.y;
    r.z += p.z;
    r.w += p.w;
  }
  out[i] = r;
}

template <int MT>
void launch_mt(const void* x, const void* q4, const void* s, float* part,
               int N, int K, int O, int row_blocks, int ksplit, int gps,
               cudaStream_t st) {
  const int smem = STAGES * SG * (int)sizeof(Stage<MT>);
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(qmm4_kernel<MT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    opted_in = true;
  }
  dim3 grid((O + TILE_O - 1) / TILE_O, row_blocks, ksplit);
  qmm4_kernel<MT><<<grid, NTHREADS, smem, st>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)q4, (const float*)s, part, N,
      K, O, gps);
}

}  // namespace

// x [N, K] bf16, q4 [K/2, O] uint8, s [K/32, O] f32 → out [N, O] f32; all
// contiguous and 16-byte aligned, K % 32 == 0 and O % 16 == 0 (the wrapper
// checks). mt (1, 2 or 4) 16-row tiles a CTA, row_blocks CTAs down the
// rows (row_blocks * mt * 16 >= N), K split ksplit ways of gps groups
// each (ops/quant.py qmm4_mma_plan). With ksplit > 1, ``work`` holds
// [ksplit, N, O] f32 partials; with ksplit == 1 it is unused. Returns
// cudaGetLastError().
extern "C" int qmm4_bf16(const void* x, const void* q4, const void* s,
                         float* out, float* work, int N, int K, int O, int mt,
                         int row_blocks, int ksplit, int gps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* part = ksplit > 1 ? work : out;
  switch (mt) {
    case 1: launch_mt<1>(x, q4, s, part, N, K, O, row_blocks, ksplit, gps, st); break;
    case 2: launch_mt<2>(x, q4, s, part, N, K, O, row_blocks, ksplit, gps, st); break;
    case 4: launch_mt<4>(x, q4, s, part, N, K, O, row_blocks, ksplit, gps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (ksplit > 1) {
    const int64_t NO4 = (int64_t)N * O / 4;
    const int threads = 256;
    sum_splits<<<(unsigned)((NO4 + threads - 1) / threads), threads, 0, st>>>(
        (const float4*)work, (float4*)out, NO4, ksplit);
  }
  return (int)cudaGetLastError();
}
