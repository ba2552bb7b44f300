// Causal GQA flash-attention over a fresh prefill chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/flash.py ::
// flash_prefill (kernel body _prefill_kernel). Same function: query i of the
// chunk attends keys j <= i (positions local to the chunk), optionally only
// inside a sliding window; S = Q . K^T is a bf16 product summed in f32,
// times the scale, with an optional tanh softcap; an f32 online softmax in
// which a row with no live key yet keeps m = NEG_INF and gets p = 0; p
// rounded to bf16 before the p . v product (the TPU kernel's
// p.astype(v.dtype)) while the sum l takes it unrounded; an f32
// accumulator divided by max(l, 1e-30) and stored in the input type. The
// TPU rounds p from the running max of a key block of up to 512 keys, this
// kernel from the running max after each 64-key tile: a difference of at
// most one bf16 ulp in some outputs.
//
// What bounds it on the card: operations. A T-token chunk does
// 4 * H * hd * T * (T + 1) / 2 flops after the causal skip (2.15 GFLOP for
// llama3.1's 512-token chunk, 77 GFLOP for phi3's 4096 tokens with window
// 2047), against 989 TFLOP/s of bf16 tensor cores; its bytes (Q, K, V in,
// O out, 4 MB at llama3.1's chunk) take a few microseconds.
//
// Design (FlashAttention-2 on mma.sync): one CTA of 4 warps per (64-row
// query tile, query head, batch row), heads varying fastest in the grid so
// that the longest (last) query tiles of every head are dispatched first and
// the short ones fill in behind them. Each warp owns 16 query rows and keeps
// their Q fragments in registers for the whole walk. K/V tiles of 64 keys
// stream through two shared-memory stages with cp.async (the next tile loads
// while this one computes); rows are padded by 16 bytes, so the 8 rows an
// ldmatrix phase reads fall in 8 distinct bank groups for every hd that is a
// multiple of 16. Both products are mma.sync.m16n8k16 bf16 -> f32: S from
// ldmatrix'd K, and P . V with V read by ldmatrix.trans. The S accumulator
// fragment is the P operand fragment: its row max and row sum are two xor
// shuffles within a quad, and converting it to bf16 pairs is the p rounding.
// Tiles above the diagonal and tiles wholly outside the window are never
// loaded; only tiles that cross the diagonal, the window's edge or the
// chunk's end are masked. Query rows past T (a ragged last tile) are
// computed on zeros and never stored, keys past T are zero-filled and
// masked. GQA reads K/V of head h / (H / KvH) and never copies them. The Q
// tile lands in the second K stage (free until the second K/V tile loads)
// and the output leaves through the first as 16-byte stores, so a CTA holds
// only the four K/V tiles (69.6 KB at hd 128: three CTAs a SM).
// Probabilities take __expf (ex2.approx of x * log2 e, a few f32 ulps off
// expf before their rounding to bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA, 16 per warp
constexpr int BK = 64;        // keys per K/V tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;

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
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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

// two f32 -> one bf16 pair, each rounded to nearest; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD, bool SOFTCAP>
__global__ void __launch_bounds__(NTHREADS, 3)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int T, int H, int KvH,
                     float scale, float softcap, int window) {
  constexpr int LD = HD + 8;       // shared row stride (elements): +16 bytes
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks per row
  constexpr int KSTEPS = HD / 16;  // k16 steps of Q . K^T
  constexpr int DTILES = HD / 8;   // n8 tiles of the output
  constexpr int NT = BK / 8;       // n8 tiles of S
  static_assert(BQ == BK, "Q and the output are staged in a K tile");
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* Ks = smem;               // [2][BK][LD]
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
  // the Q tile lands in the second K stage, free until the second K/V tile
  // loads; the output goes out through the first
  __nv_bfloat16* Qs = Ks + BK * LD;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int kvh = h / (H / KvH);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  for (int c = tid; c < BQ * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const int qi = q0 + r;
    cp_async16(smem_u32(Qs + r * LD + col),
               q + (((int64_t)b * T + min(qi, T - 1)) * H + h) * HD + col,
               qi < T ? 16 : 0);
  }
  cp_async_commit();

  const int q_last = min(q0 + BQ, T) - 1;
  int k_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    if (lo > 0) k_begin = (lo / BK) * BK;
  }
  const int n_tiles = (q_last - k_begin) / BK + 1;
  const int64_t kv_row0 = ((int64_t)b * KvH + kvh) * T;

  auto load_kv = [&](int k0, int stage) {
    __nv_bfloat16* ks = Ks + stage * BK * LD;
    __nv_bfloat16* vs = Vs + stage * BK * LD;
    for (int c = tid; c < BK * CHUNKS; c += NTHREADS) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
      const int kk = k0 + r;
      const int64_t off = (kv_row0 + min(kk, T - 1)) * HD + col;
      const int n = kk < T ? 16 : 0;
      cp_async16(smem_u32(ks + r * LD + col), k + off, n);
      cp_async16(smem_u32(vs + r * LD + col), v + off, n);
    }
  };

  load_kv(k_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();

  const int wrow = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
    ldmatrix_x4(qf[s], smem_u32(Qs + (wrow + (lane & 15)) * LD + s * 16 +
                                (lane >> 4) * 8));
  __syncthreads();  // every warp holds its Q fragments: stage 1 is free

  float o[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + wrow + g;  // this lane's rows: row0 and row0 + 8
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, row

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK;
    if (it + 1 < n_tiles) {
      load_kv(k0 + BK, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = Ks + (it & 1) * BK * LD;
    const __nv_bfloat16* vs = Vs + (it & 1) * BK * LD;

    // S = Q . K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(ks + (np * 16 + mr + 8 * (mi >> 1)) * LD +
                                 st * 16 + 8 * (mi & 1)));
        mma_bf16(s[2 * np], qf[st], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[st], kb[2], kb[3]);
      }
    }

    const bool need_mask = (k0 + BK - 1 > q0) || (k0 + BK > T) ||
                           (window > 0 && k0 <= q_last - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (SOFTCAP) x = softcap * tanhf(x / softcap);
        if (need_mask) {
          const int qi = row0 + (e >> 1) * 8;
          const int kk = k0 + n * 8 + 2 * t4 + (e & 1);
          bool ok = (kk <= qi) && (kk < T);
          if (window > 0) ok = ok && (kk > qi - window);
          if (!ok) x = NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_new[2];
    bool live[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_r[r], quad_max(mx[r]));
      alpha[r] = __expf(m_r[r] - m_new[r]);
      m_r[r] = m_new[r];
      // a row with no live key yet keeps m == NEG_INF: its p is gated to 0
      // so masked NEG_INF scores do not turn into exp(0) = 1
      live[r] = m_new[r] > NEG_INF * 0.5f;
    }

    // p = exp(s - m) as bf16 A fragments of P . V (k16 step j takes the
    // key n-tiles 2j and 2j + 1); l sums the unrounded p
    uint32_t pf[NT / 2][4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = live[0] ? __expf(s[n][0] - m_new[0]) : 0.f;
      const float p1 = live[0] ? __expf(s[n][1] - m_new[0]) : 0.f;
      const float p2 = live[1] ? __expf(s[n][2] - m_new[1]) : 0.f;
      const float p3 = live[1] ? __expf(s[n][3] - m_new[1]) : 0.f;
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + quad_sum(psum[r]);
#pragma unroll
    for (int d = 0; d < DTILES; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P . V
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
      for (int dp = 0; dp < DTILES / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vs + (j * 16 + mr + 8 * (mi & 1)) * LD +
                                       dp * 16 + 8 * (mi >> 1)));
        mma_bf16(o[2 * dp], pf[j], vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pf[j], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  // out = o / max(l, 1e-30) as bf16, staged in this warp's rows of the
  // first K stage (every warp is past the loop's last barrier)
  __nv_bfloat16* os = Ks + wrow * LD;
  const float l0 = fmaxf(l_r[0], 1e-30f), l1 = fmaxf(l_r[1], 1e-30f);
#pragma unroll
  for (int d = 0; d < DTILES; ++d) {
    *reinterpret_cast<uint32_t*>(os + g * LD + d * 8 + 2 * t4) =
        pack_bf16(o[d][0] / l0, o[d][1] / l0);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + d * 8 + 2 * t4) =
        pack_bf16(o[d][2] / l1, o[d][3] / l1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CHUNKS; c += 32) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const int qi = q0 + wrow + r;
    if (qi < T)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * T + qi) * H + h) * HD +
                                col) =
          *reinterpret_cast<const uint4*>(os + r * LD + col);
  }
}

template <int HD, bool SOFTCAP>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int T, int H, int KvH, float scale, float softcap, int window,
            cudaStream_t st) {
  const int smem = 4 * BK * (HD + 8) * (int)sizeof(__nv_bfloat16);
  static bool opted_in = false;
  if (!opted_in) {
    cudaFuncSetAttribute(flash_prefill_kernel<HD, SOFTCAP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    opted_in = true;
  }
  // heads vary fastest, so the longest (last) query tiles of every head
  // are dispatched first and the short ones fill in behind them
  dim3 grid(H, (T + BQ - 1) / BQ, B);
  flash_prefill_kernel<HD, SOFTCAP><<<grid, NTHREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, T, H, KvH, scale,
      softcap, window);
}

// the tanh softcap is a template switch: its code, unused by most models,
// would otherwise cost registers in every instantiation
template <int HD>
void launch_hd(const void* q, const void* k, const void* v, void* out, int B,
               int T, int H, int KvH, float scale, float softcap, int window,
               cudaStream_t st) {
  if (softcap > 0.f)
    launch<HD, true>(q, k, v, out, B, T, H, KvH, scale, softcap, window, st);
  else
    launch<HD, false>(q, k, v, out, B, T, H, KvH, scale, softcap, window, st);
}

}  // namespace

// q [B, T, H, hd], k/v head-first [B, KvH, T, hd], out [B, T, H, hd]; all
// bf16, contiguous and 16-byte aligned. hd must be a multiple of 16 and at
// most 128, and H a multiple of KvH (the wrapper checks). Returns
// cudaGetLastError().
extern "C" int flash_prefill_bf16(const void* q, const void* k, const void* v,
                                  void* out, int B, int T, int H, int KvH,
                                  int hd, float scale, float softcap,
                                  int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
#define HD_CASE(n)                                                         \
  case n:                                                                  \
    launch_hd<n>(q, k, v, out, B, T, H, KvH, scale, softcap, window, st);  \
    break;
    HD_CASE(16) HD_CASE(32) HD_CASE(48) HD_CASE(64)
    HD_CASE(80) HD_CASE(96) HD_CASE(112) HD_CASE(128)
#undef HD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
