// Single-token attention against the dense head-first slot cache, for Hopper
// (sm_90a): GQA (decode_attention_bf16) and MHA (mha_decode_bf16).
//
// Replaces the TPU kernels ollama_operator_tpu/ops/pallas/flash.py ::
// decode_attention (K2, kernel body _decode_kernel) and mha_decode_attention
// (K3, kernel body _mha_decode_kernel). Same function: the query rows of
// slot b, at absolute position q_pos[b], attend cache rows j <= q_pos[b]
// (and j > q_pos[b] - window when window > 0); scores in f32, scaled, then
// soft-capped; an f32 online softmax started at NEG_INF = -1e30 (a row with
// no live key stays finite and gives 0); out = acc / max(l, 1e-30) in bf16.
// As the TPU's K2 does for a bf16 cache, the GQA entry rounds each
// probability to bf16 before the p.v product (the normaliser l sums them
// unrounded); K3 keeps them in f32, as the TPU's K3 does.
//
// What bounds it on the card: bytes. Each live cache row (hd bf16 of K and
// of V) is read once per (slot, kv head) and feeds 4 * G * hd operations,
// i.e. at most 8 operations a byte for G <= 8, far below the card's ~295.
//
// Design. The TPU kernels walk fixed blocks of up to 512 rows in grid order
// and skip those past q_pos; here a CTA walks exactly the live rows
// [max(0, q_pos - window + 1), min(q_pos, S - 1)] in 32-row tiles, and a
// warp owns a tile. Its lanes copy the tile's K and V rows (contiguous in
// the cache) into the warp's own shared buffers with 16-byte cp.async
// copies, two tiles in flight, so the next tile's copy overlaps this tile's
// math. Lane j scores row j against the G query rows (staged once in shared
// memory as f32); warp shuffles give the tile's max and sum; then lane l
// accumulates the bf16 pairs (4-byte words) l, l + 32, ... of every V row,
// so hd = 96 (48 words) needs no power of two. Shared rows are padded by 16
// bytes (32 when hd / 8 is odd) so the lanes' 16-byte row reads fall on
// distinct banks.
//
// GQA (K2): one CTA per (kv head, slot) holds the G <= 8 query rows of its
// group; its NW warps take the tiles round robin, each with its own running
// max, sum and accumulator, merged through shared memory at the end. MHA
// (K3): the TPU kernel tiles 8 heads a program because a G = 1 program
// leaves 7/8 of the MXU's rows idle; here query rows are not the parallel
// axis (a lane scores a key), so the same warp-tile code runs compiled for
// one query row, one CTA per (head, slot).
//
// Cache layout: row j of (slot b, kv head h) starts at element
// b * stride_b + h * stride_h + j * hd, so a [B, KvH, A, hd] view that is a
// prefix of a longer cache (A < S) is read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;     // cache rows a warp stages and scores at once
constexpr int MAX_HD = 256;
constexpr int MAX_NW2 = MAX_HD / 2 / 32;  // V words a lane owns: hd <= 256
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row pitch of a staged tile in bytes: the row plus 16 bytes, or 32 when
// hd / 8 is odd, so that 8 lanes reading 16 bytes of 8 consecutive rows
// touch all 32 banks once.
__host__ __device__ inline int tile_pitch(int hd) {
  return 2 * hd + (((hd / 8) & 1) ? 32 : 16);
}

// MAXG is the largest group the instantiation takes: 8 for the GQA entry,
// 1 for the MHA entry. The GQA entry rounds p to bf16 before the p.v
// product, as the TPU's K2 feeds the MXU; the MHA entry keeps it in f32,
// as the TPU's K3 does its products on the VPU.
template <int MAXG>
__global__ void __launch_bounds__(128)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ q_pos, __nv_bfloat16* __restrict__ out,
              int H, int KvH, int S, int hd, int64_t stride_b,
              int64_t stride_h, float scale, float softcap, int window) {
  constexpr bool ROUND_P = MAXG > 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KvH;
  const int NW = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pitch = tile_pitch(hd);
  const int chunks = hd / 8;   // 16-byte chunks a row
  const int words = hd / 2;    // bf16 pairs a row
  float* qs = (float*)smem;                          // [G][hd]
  float* Ps = qs + G * hd;                           // [NW][MAXG][TILE]
  unsigned char* tiles = (unsigned char*)(Ps + NW * MAXG * TILE);
  // warp w, stage st: K tile at ((w * 2 + st) * 2) * TILE * pitch, V after it
  unsigned char* mine = tiles + (size_t)warp * 4 * TILE * pitch;
  float* Pw = Ps + warp * MAXG * TILE;

  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x)
    qs[idx] = __bfloat162float(q[((int64_t)b * H + kvh * G) * hd + idx]);

  const int qp = q_pos[b];
  int lo = 0;
  if (window > 0 && qp - window + 1 > 0) lo = qp - window + 1;
  const int hi = min(qp, S - 1);
  const int n_live = hi - lo + 1;
  const int ntiles = n_live > 0 ? (n_live + TILE - 1) / TILE : 0;
  const int64_t base = (int64_t)b * stride_b + (int64_t)kvh * stride_h;

  auto stage = [&](int t, int st) {
    const int k0 = lo + t * TILE;
    const int nrows = min(TILE, hi + 1 - k0);
    unsigned char* kt = mine + (size_t)st * 2 * TILE * pitch;
    unsigned char* vt = kt + (size_t)TILE * pitch;
    const __nv_bfloat16* kg = k + base + (int64_t)k0 * hd;
    const __nv_bfloat16* vg = v + base + (int64_t)k0 * hd;
    for (int idx = lane; idx < nrows * chunks; idx += 32) {
      const int r = idx / chunks, c = idx - r * chunks;
      cp_async16(kt + r * pitch + c * 16, kg + (int64_t)r * hd + c * 8);
      cp_async16(vt + r * pitch + c * 16, vg + (int64_t)r * hd + c * 8);
    }
  };

  float m[MAXG], l[MAXG], acc[MAXG][2 * MAX_NW2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < 2 * MAX_NW2; ++c) acc[g][c] = 0.f;
  }

  int t = warp;
  if (t < ntiles) stage(t, 0);
  cp_async_commit();
  __syncthreads();  // q staged
  for (int it = 0; t < ntiles; ++it, t += NW) {
    if (t + NW < ntiles) stage(t + NW, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (all but the newest group)
    __syncwarp();
    const unsigned char* kt = mine + (size_t)(it & 1) * 2 * TILE * pitch;
    const unsigned char* vt = kt + (size_t)TILE * pitch;
    const int k0 = lo + t * TILE;
    const int nrows = min(TILE, hi + 1 - k0);

    // lane j scores row j against the G query rows
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (lane < nrows) {
      const uint4* krow = (const uint4*)(kt + lane * pitch);
      for (int c = 0; c < chunks; ++c) {
        const uint4 w = krow[c];
        const float kv[8] = {lo_bf16(w.x), hi_bf16(w.x), lo_bf16(w.y),
                             hi_bf16(w.y), lo_bf16(w.z), hi_bf16(w.z),
                             lo_bf16(w.w), hi_bf16(w.w)};
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4 qa = *(const float4*)(qs + g * hd + c * 8);
            const float4 qb = *(const float4*)(qs + g * hd + c * 8 + 4);
            float a = s[g];
            a = fmaf(qa.x, kv[0], a);
            a = fmaf(qa.y, kv[1], a);
            a = fmaf(qa.z, kv[2], a);
            a = fmaf(qa.w, kv[3], a);
            a = fmaf(qb.x, kv[4], a);
            a = fmaf(qb.y, kv[5], a);
            a = fmaf(qb.z, kv[6], a);
            a = fmaf(qb.w, kv[7], a);
            s[g] = a;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float x = s[g] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        x = lane < nrows ? x : NEG_INF;
        const float m_new = fmaxf(m[g], warp_max(x));
        const float alpha = expf(m[g] - m_new);
        const float p =
            (lane < nrows && m_new > NEG_INF * 0.5f) ? expf(x - m_new) : 0.f;
        l[g] = l[g] * alpha + warp_sum(p);
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < 2 * MAX_NW2; ++c) acc[g][c] *= alpha;
        Pw[g * TILE + lane] =
            ROUND_P ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
    }
    __syncwarp();

    // lane l accumulates V words l, l + 32, ... of the tile's rows
    for (int j = 0; j < nrows; ++j) {
      const uint32_t* vrow = (const uint32_t*)(vt + j * pitch);
      float pj[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) pj[g] = g < G ? Pw[g * TILE + j] : 0.f;
#pragma unroll
      for (int c = 0; c < MAX_NW2; ++c) {
        const int wd = lane + 32 * c;
        if (wd < words) {
          const uint32_t w = vrow[wd];
          const float v0 = lo_bf16(w), v1 = hi_bf16(w);
#pragma unroll
          for (int g = 0; g < MAXG; ++g) {
            if (g < G) {
              acc[g][2 * c] = fmaf(pj[g], v0, acc[g][2 * c]);
              acc[g][2 * c + 1] = fmaf(pj[g], v1, acc[g][2 * c + 1]);
            }
          }
        }
      }
    }
    __syncwarp();  // this stage is read before it is staged again
  }
  cp_async_wait<0>();

  // merge the warps' partial softmax states: M = max over warps of m,
  // out = sum(acc_w * e_w) / max(sum(l_w * e_w), 1e-30), e_w = exp(m_w - M)
  __syncthreads();  // every warp is done with its tiles
  float* Mw = (float*)tiles;            // [NW][MAXG]
  float* Lw = Mw + NW * MAXG;           // [NW][MAXG]
  float* Aw = Lw + NW * MAXG;           // [NW][G][hd]
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        Mw[warp * MAXG + g] = m[g];
        Lw[warp * MAXG + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < MAX_NW2; ++c) {
        const int wd = lane + 32 * c;
        if (wd < words) {
          float* a = Aw + ((size_t)warp * G + g) * hd + 2 * wd;
          a[0] = acc[g][2 * c];
          a[1] = acc[g][2 * c + 1];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int g = idx / hd, d = idx - g * hd;
    float M = NEG_INF;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * MAXG + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float e = expf(Mw[w * MAXG + g] - M);
      L = fmaf(Lw[w * MAXG + g], e, L);
      A = fmaf(Aw[((size_t)w * G + g) * hd + d], e, A);
    }
    out[((int64_t)b * H + kvh * G) * hd + idx] =
        __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

// Warps a CTA: two staged tiles a warp must fit in shared memory.
inline int warps_for(int hd) { return hd <= 128 ? 4 : 2; }

// Dynamic shared memory of a launch: the G query rows, the warps' p rows
// and their double-buffered K/V tiles (the merge at the end reuses the
// tiles), laid out as decode_kernel<MAXG> reads them.
template <int MAXG>
size_t smem_bytes(int G, int hd) {
  const int nw = warps_for(hd);
  return sizeof(float) * ((size_t)G * hd + (size_t)nw * MAXG * TILE) +
         (size_t)nw * 4 * TILE * tile_pitch(hd);
}

template <int MAXG>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           void* out, int B, int H, int KvH, int S, int hd, long long stride_b,
           long long stride_h, float scale, float softcap, int window,
           void* stream) {
  const int G = H / KvH;
  if (H % KvH || G > MAXG || hd % 8 || hd > MAX_HD || S < 1)
    return (int)cudaErrorInvalidValue;
  // the shared memory cap is raised once per instantiation, to what its
  // largest launch needs (every hd it takes), not on every launch
  static const cudaError_t cap = [] {
    size_t most = 0;
    for (int d = 8; d <= MAX_HD; d += 8) {
      const size_t need = smem_bytes<MAXG>(MAXG, d);
      most = most > need ? most : need;
    }
    return cudaFuncSetAttribute(decode_kernel<MAXG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)most);
  }();
  if (cap != cudaSuccess) return (int)cap;
  dim3 grid(KvH, B);
  decode_kernel<MAXG><<<grid, 32 * warps_for(hd), smem_bytes<MAXG>(G, hd),
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, q_pos, (__nv_bfloat16*)out, H, KvH, S, hd,
      (int64_t)stride_b, (int64_t)stride_h, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

// GQA decode (K2). q [B, 1, H, hd] bf16 contiguous; k/v bf16 rows of hd
// contiguous elements, row j of (b, h) at b * stride_b + h * stride_h +
// j * hd (16-byte aligned: the wrapper checks); S rows per (b, h); q_pos [B]
// int32; out [B, 1, H, hd] bf16. H % KvH == 0, H / KvH <= 8, hd % 8 == 0,
// hd <= 256. Returns cudaGetLastError() (cudaErrorInvalidValue for shapes
// it does not take).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const int* q_pos,
                                     void* out, int B, int H, int KvH, int S,
                                     int hd, long long stride_b,
                                     long long stride_h, float scale,
                                     float softcap, int window, void* stream) {
  return launch<8>(q, k, v, q_pos, out, B, H, KvH, S, hd, stride_b, stride_h,
                   scale, softcap, window, stream);
}

// MHA decode (K3): the same arguments with KvH == H (one query row a CTA).
extern "C" int mha_decode_bf16(const void* q, const void* k, const void* v,
                               const int* q_pos, void* out, int B, int H,
                               int S, int hd, long long stride_b,
                               long long stride_h, float scale, float softcap,
                               int window, void* stream) {
  return launch<1>(q, k, v, q_pos, out, B, H, H, S, hd, stride_b, stride_h,
                   scale, softcap, window, stream);
}
