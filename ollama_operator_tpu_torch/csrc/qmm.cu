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
// y is f32 and every product is exact in f32 (a bf16 times a bf16; an int8
// code in [-127, 127] is exact in bf16). Codes are int8 [K, O], one f32
// scale per group of 32 rows and column. The form follows the call's N,
// not the row tile.
//
// What bounds it on the card: bytes at decode sizes (at N = 64 the w_gate
// call, K = 3072 and O = 8192, moves 28.3 MB of codes and scales for 3.2
// GFLOP, 8.4 us at 3.35 TB/s), operations at prefill sizes (N = 512:
// 25.8 GFLOP, 0.026 ms at 989 TFLOP/s).
//
// Design (qmm4.cu's, with one code byte a weight): bf16 tensor cores
// (mma.sync.m16n8k16, f32 accumulation) fed by a multi-stage cp.async
// pipeline. A CTA of 8 warps owns 256 output columns and MT 16-row tiles of
// x (MT = 1 at N <= 16, 2 at N <= 32, 4 at N <= 64, else 8; rows past N are
// zero-filled). A pipeline step holds two K groups, each with its 32 rows of
// codes (16-byte chunks of rows of O contiguous bytes, padded by 16 bytes so
// the fragment reads are free of bank conflicts), its row of f32 scales and
// its x tile. Warps split the columns, not the rows: warp w owns columns
// 32w .. 32w + 31 of the tile as 4 n8 tiles, lane (g, t) holding column
// 4g + c of n-tile c, so one 32-bit load per code row gives a lane the
// bytes of its 4 columns, and the rows 2t, 2t + 1, 2t + 8, 2t + 9 of each
// k16 step are its B fragments. A code byte becomes a float with one byte
// permute into 2^23's mantissa (sign bit flipped, a +128 bias) and one
// subtraction; N > 16 multiplies it by the f32 scale, and pairs are rounded
// to bf16. Each weight is dequantized once per CTA and its fragment feeds
// every 16-row tile; at N > 64 a CTA holds 128 rows, so a 512-row prefill
// dequantizes each weight 4 times, not 8. The decode form runs each group's
// two k16 steps into a fresh accumulator and adds it, times the f32 scale
// of its column, to the running sum. In this layout a lane's accumulators
// cover 8 adjacent output columns, written as two float4. When the column
// and row tiles alone leave the card underfilled (decode), K is split over
// gridDim.z (ops/quant.py qmm_mma_plan); each split writes its own partial
// [N, O] and a second kernel sums the splits in split order (no float
// atomics), so a repeated call gives identical results.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 32;
constexpr int TILE_O = 256;           // columns per CTA, 32 per warp
constexpr int NTHREADS = 256;
constexpr int SG = 2;                 // K groups a pipeline step
constexpr int STAGES = 3;             // pipeline steps in shared memory
constexpr int CODE_LD = TILE_O + 16;  // bytes per code row in shared memory
constexpr int X_LD = GROUP + 8;       // bf16 per x row in shared memory

template <int MT>
struct Stage {
  uint8_t codes[GROUP][CODE_LD];
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

// d += a . b, one 16x8x16 bf16 tile with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the int8 code in byte c of w, whose sign bits were flipped (the byte is
// code + 128): the byte goes into the mantissa of 2^23, and 2^23 + 128
// comes off exactly
__device__ __forceinline__ float code_of(uint32_t w, int c) {
  const float f = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | c));
  return f - 8388736.f;
}

// two weights (k and k + 1 of one column) -> a bf16 pair, each rounded to
// nearest; k in the low half, as the B fragment takes them
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// DECODE (MT = 1 only): the decode form, B = the exact code and the scale
// after each group; else B = bf16(code * scale)
template <int MT, bool DECODE>
__global__ void __launch_bounds__(NTHREADS, MT == 8 ? 1 : 2)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, float* __restrict__ part, int N,
           int K, int O, int groups_per_split) {
  static_assert(!DECODE || MT == 1, "the decode form is for N <= 16");
  static_assert(GROUP * (TILE_O / 16) == 2 * NTHREADS,
                "two 16-byte chunks of codes a thread per group");
  constexpr int XCHUNKS = MT * 16 * (GROUP / 8);  // 16-byte chunks of x
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

  // this thread's copies, the same in every group: two 16-byte chunks of
  // codes (rows cr and cr + 16), one of scales (tid < TILE_O / 4) and up to
  // two of x; chunks past O or rows past N are zero-filled from a clamped
  // address
  const int cr = tid / (TILE_O / 16), ccol = (tid % (TILE_O / 16)) * 16;
  const uint32_t c_dst = cr * CODE_LD + ccol;
  const int8_t* c_src =
      q + ((int64_t)g0 * GROUP + cr) * O + min(o_tile + ccol, O - 16);
  const int c_n = o_tile + ccol < O ? 16 : 0;
  const int64_t c_half = (int64_t)(GROUP / 2) * O;
  const uint32_t s_dst = GROUP * CODE_LD + 16 * tid;
  const float* s_src = s + (int64_t)g0 * O + min(o_tile + 4 * tid, O - 4);
  const int s_n = o_tile + 4 * tid < O ? 16 : 0;
  uint32_t x_dst[2];
  const __nv_bfloat16* x_src[2];
  int x_n[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * NTHREADS;
    const int xr = idx / (GROUP / 8), xcol = (idx % (GROUP / 8)) * 8;
    x_dst[i] = GROUP * CODE_LD + 4 * TILE_O + 2 * (xr * X_LD + xcol);
    x_src[i] = x + (int64_t)min(n0 + xr, N - 1) * K + g0 * GROUP + xcol;
    x_n[i] = n0 + xr < N ? 16 : 0;
  }
  const int64_t c_step = (int64_t)GROUP * O;

  auto load = [&](int gi, int slot) {  // group g0 + gi into slot
    const uint32_t base = smem0 + slot * (uint32_t)sizeof(Stage<MT>);
    const int8_t* cs = c_src + gi * c_step;
    cp_async16(base + c_dst, cs, c_n);
    cp_async16(base + c_dst + (GROUP / 2) * CODE_LD, cs + c_half, c_n);
    if (tid < TILE_O / 4)
      cp_async16(base + s_dst, s_src + (int64_t)gi * O, s_n);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (tid + i * NTHREADS < XCHUNKS)
        cp_async16(base + x_dst[i], x_src[i] + gi * GROUP, x_n[i]);
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

  const int wc = warp * 32 + 4 * g;  // this lane's 4 B columns in the tile
  const int ac = warp * 32 + 8 * t4;  // its 8 accumulator columns
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
      float sc[4];
      if (!DECODE) {
        const float4 sc4 = *reinterpret_cast<const float4*>(&S.scales[wc]);
        sc[0] = sc4.x, sc[1] = sc4.y, sc[2] = sc4.z, sc[3] = sc4.w;
      }
      float gacc[4][4];  // the decode form's group sum
      if (DECODE) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[c][e] = 0.f;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // k16 steps: rows 16 half + ..
        const int r0 = 16 * half + 2 * t4;
        uint32_t w[4] = {
            *reinterpret_cast<const uint32_t*>(&S.codes[r0][wc]),
            *reinterpret_cast<const uint32_t*>(&S.codes[r0 + 1][wc]),
            *reinterpret_cast<const uint32_t*>(&S.codes[r0 + 8][wc]),
            *reinterpret_cast<const uint32_t*>(&S.codes[r0 + 9][wc])};
#pragma unroll
        for (int r = 0; r < 4; ++r) w[r] ^= 0x80808080u;
        uint32_t bf[4][2];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (DECODE) {
            bf[c][0] = pack_bf16(code_of(w[0], c), code_of(w[1], c));
            bf[c][1] = pack_bf16(code_of(w[2], c), code_of(w[3], c));
          } else {
            bf[c][0] = pack_bf16(code_of(w[0], c) * sc[c],
                                 code_of(w[1], c) * sc[c]);
            bf[c][1] = pack_bf16(code_of(w[2], c) * sc[c],
                                 code_of(w[3], c) * sc[c]);
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_u32(&S.x[m * 16 + (lane & 15)]
                                      [half * 16 + (lane >> 4) * 8]));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (DECODE)
              mma_bf16(gacc[c], a, bf[c][0], bf[c][1]);
            else
              mma_bf16(acc[m][c], a, bf[c][0], bf[c][1]);
          }
        }
      }
      if (DECODE) {
        // accumulator e of n-tile c is column ac + 4 * (e & 1) + c
        const float4 lo = *reinterpret_cast<const float4*>(&S.scales[ac]);
        const float4 hi = *reinterpret_cast<const float4*>(&S.scales[ac + 4]);
        const float se[2][4] = {{lo.x, lo.y, lo.z, lo.w},
                                {hi.x, hi.y, hi.z, hi.w}};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[0][c][e] = fmaf(gacc[c][e], se[e & 1][c], acc[0][c][e]);
      }
    }
  }

  // accumulator (row g or g + 8, n8 column 2t + e) of n-tile c is output
  // column 32w + 4 * (2t + e) + c: a lane holds columns 8t .. 8t + 7
  float* dst = part + (int64_t)blockIdx.z * N * O;
  const int o = o_tile + ac;
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

template <int MT, bool DECODE>
cudaError_t launch_mt(const void* x, const void* q, const void* s,
                      float* part, int N, int K, int O, int row_blocks,
                      int ksplit, int gps, cudaStream_t st) {
  const int smem = STAGES * SG * (int)sizeof(Stage<MT>);
  // the shared memory cap is raised once per instantiation
  static const cudaError_t cap = cudaFuncSetAttribute(
      qmm_kernel<MT, DECODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (cap != cudaSuccess) return cap;
  dim3 grid((O + TILE_O - 1) / TILE_O, row_blocks, ksplit);
  qmm_kernel<MT, DECODE><<<grid, NTHREADS, smem, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)q, (const float*)s, part, N, K,
      O, gps);
  return cudaSuccess;
}

}  // namespace

// x [N, K] bf16, q [K, O] int8, s [K/32, O] f32 → out [N, O] f32; all
// contiguous and 16-byte aligned, K % 32 == 0 and O % 16 == 0 (the wrapper
// checks). mt 16-row tiles a CTA (1 at N <= 16, where the kernel takes the
// decode form; 2, 4 or 8 above), row_blocks CTAs down the rows
// (row_blocks * mt * 16 >= N), K split ksplit ways of gps groups each
// (ops/quant.py qmm_mma_plan). With ksplit > 1, ``work`` holds
// [ksplit, N, O] f32 partials; with ksplit == 1 it is unused. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a plan it does not take).
extern "C" int qmm_bf16(const void* x, const void* q, const void* s,
                        float* out, float* work, int N, int K, int O, int mt,
                        int row_blocks, int ksplit, int gps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* part = ksplit > 1 ? work : out;
  if ((mt == 1) != (N <= 16)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (mt) {
#define MT_CASE(n, decode)                                               \
  case n:                                                                \
    err = launch_mt<n, decode>(x, q, s, part, N, K, O, row_blocks, ksplit, \
                               gps, st);                                 \
    break;
    MT_CASE(1, true) MT_CASE(2, false) MT_CASE(4, false) MT_CASE(8, false)
#undef MT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (ksplit > 1) {
    const int64_t NO4 = (int64_t)N * O / 4;
    const int threads = 256;
    sum_splits<<<(unsigned)((NO4 + threads - 1) / threads), threads, 0, st>>>(
        (const float4*)work, (float4*)out, NO4, ksplit);
  }
  return (int)cudaGetLastError();
}
