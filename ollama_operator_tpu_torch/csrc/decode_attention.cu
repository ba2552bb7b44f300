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
// [max(0, q_pos - window + 1), min(q_pos, S - 1)] of its chunk in 32-row
// tiles, and a warp owns a tile: its lanes copy the tile's K and V rows
// (contiguous in the cache) into the warp's own shared buffers with 16-byte
// cp.async copies, two tiles in flight when the warp has more than one, so
// the next tile's copy overlaps this tile's math. The warps of a CTA keep
// their own running max, sum and accumulator and merge them through shared
// memory at the end.
//
// Both entries split the sequence (flash-decoding): the grid is (kv head,
// slot, chunk of ``chunk`` rows), chunk z covering rows [z * chunk,
// (z + 1) * chunk), so a long slot no longer walks all its tiles on one
// CTA's four warps. Each CTA stores its partial softmax state (m, l,
// acc[G][hd]) in f32; a chunk with no live row (past q_pos, or before the
// window) stores m = NEG_INF, l = 0 and exits. A second launch
// (merge_chunks) combines each (kv head, slot, query row)'s chunks in chunk
// order, so a repeat gives the same bits. The grid depends on S and the
// chunk size only, never on the lengths, so no length is read back to the
// host. GQA (K2) at hd a multiple of 16 up to 128 scores and sums on
// tensor cores (decode_mma_kernel: the group's G query rows are the rows of
// a 16-row mma tile, as in the flash-prefill kernel); other head dims take
// the scalar kernel below.
//
// MHA (K3): the TPU kernel tiles 8 heads a program because a G = 1 program
// leaves 7/8 of the MXU's rows idle; here the scalar warp-tile code runs
// compiled for one query row, one CTA per (head, slot, chunk). In the
// scalar kernel lane j scores row j against the query rows (staged once in
// shared memory as f32); warp shuffles give the tile's max
// and sum; then lane l accumulates the bf16 pairs (4-byte words) l, l + 32,
// ... of every V row, so hd = 96 (48 words) needs no power of two. Shared
// rows are padded by 16 bytes (32 when hd / 8 is odd) so the lanes' 16-byte
// row reads fall on distinct banks.
//
// Cache layout: row j of (slot b, kv head h) starts at element
// b * stride_b + h * stride_h + j * hd, so a [B, KvH, A, hd] view that is a
// prefix of a longer cache (A < S) is read in place.

#include "split_decode.cuh"

namespace {

using namespace split;

constexpr int TILE = 32;     // cache rows a warp stages and scores at once
constexpr int MAX_HD = 256;
constexpr int MAX_NW2 = MAX_HD / 2 / 32;  // V words a lane owns: hd <= 256

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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Row pitch of a staged tile in bytes: the row plus 16 bytes, or 32 when
// hd / 8 is odd, so that 8 lanes reading 16 bytes of 8 consecutive rows
// touch all 32 banks once.
__host__ __device__ inline int tile_pitch(int hd) {
  return 2 * hd + (((hd / 8) & 1) ? 32 : 16);
}

// Staged tiles a warp holds: two (the next one's copy overlaps this one's
// math), or one when a chunk has no more tiles than the CTA has warps.
__host__ __device__ inline int tile_stages(int chunk, int nw) {
  return chunk <= nw * TILE ? 1 : 2;
}

// The live rows [lo, hi] of a query at qp: [max(0, qp - window + 1),
// min(qp, S - 1)] inside chunk z's [z * chunk, (z + 1) * chunk)
// (ops/attention.py decode_chunk_rows); false when there are none. The
// entries refuse chunk <= 0, so the test below always holds; it stays
// because nvcc 12.8 (-O3, sm_90a) does not finish compiling this file when
// the clamp is unconditional.
__device__ __forceinline__ bool chunk_rows(int qp, int S, int window,
                                           int chunk, int z, int& lo,
                                           int& hi) {
  lo = window > 0 && qp - window + 1 > 0 ? qp - window + 1 : 0;
  hi = min(qp, S - 1);
  if (chunk > 0) {
    lo = max(lo, z * chunk);
    hi = min(hi, z * chunk + chunk - 1);
  }
  return lo <= hi;
}

// MAXG is the largest group the instantiation takes: 8 for the GQA entry,
// 1 for the MHA entry. The GQA entry rounds p to bf16 before the p.v
// product, as the TPU's K2 feeds the MXU; the MHA entry keeps it in f32,
// as the TPU's K3 does its products on the VPU. The CTA takes chunk
// blockIdx.z of the rows and stores its partial state as run
// blockIdx.y * gridDim.z + blockIdx.z of part_acc [runs, KvH, G, hd] and
// part_ml [runs, KvH, G, 2] (m, l).
template <int MAXG>
__global__ void __launch_bounds__(128)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int* __restrict__ q_pos, float* __restrict__ part_acc,
              float* __restrict__ part_ml,
              int H, int KvH, int S, int hd, int64_t stride_b,
              int64_t stride_h, float scale, float softcap, int window,
              int chunk) {
  constexpr bool ROUND_P = MAXG > 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KvH;
  const int NW = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pitch = tile_pitch(hd);
  const int nst = tile_stages(chunk, NW);
  const int chunks = hd / 8;   // 16-byte chunks a row
  const int words = hd / 2;    // bf16 pairs a row
  float* qs = (float*)smem;                          // [G][hd]
  float* Ps = qs + G * hd;                           // [NW][MAXG][TILE]
  unsigned char* tiles = (unsigned char*)(Ps + NW * MAXG * TILE);
  // warp w, stage st: K tile at ((w * nst + st) * 2) * TILE * pitch, V
  // after it
  unsigned char* mine = tiles + (size_t)warp * nst * 2 * TILE * pitch;
  float* Pw = Ps + warp * MAXG * TILE;

  const int64_t run_e =
      (((int64_t)b * gridDim.z + blockIdx.z) * KvH + kvh) * G;
  int lo, hi;
  if (!chunk_rows(q_pos[b], S, window, chunk, blockIdx.z, lo, hi)) {
    if (threadIdx.x < G) {  // no live row in this chunk: a partial of 0
      part_ml[(run_e + threadIdx.x) * 2] = NEG_INF;
      part_ml[(run_e + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }
  const int n_live = hi - lo + 1;

  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x)
    qs[idx] = __bfloat162float(q[((int64_t)b * H + kvh * G) * hd + idx]);

  const int ntiles = (n_live + TILE - 1) / TILE;
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

  // merge the warps' partial softmax states and store the chunk's: M = max
  // over warps of m, L = sum(l_w * e_w), A = sum(acc_w * e_w),
  // e_w = exp(m_w - M)
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
    part_acc[(run_e + g) * hd + d] = A;
    if (d == 0) {
      part_ml[(run_e + g) * 2] = M;
      part_ml[(run_e + g) * 2 + 1] = L;
    }
  }
}

// GQA decode on tensor cores (HD a multiple of 16, at most 128). One CTA of
// 4 warps per (kv head, slot, chunk); the G <= 8 query rows of the group are
// the rows of a 16-row mma tile (rows G .. 15 zero), kept by every warp as
// A fragments for the whole walk. A warp takes the chunk's 32-row tiles
// round robin, copies each tile's K and V rows into its own shared buffers
// (rows past the live range zero-filled, 16-byte row padding so the 8 rows
// an ldmatrix phase reads fall on distinct banks), S = Q . K^T with K read
// by ldmatrix, and O += P . V with V read by ldmatrix.trans, as the
// flash-prefill kernel does. The S accumulator fragment is the P operand
// fragment: a row's max and sum are two xor shuffles in a quad, and packing
// it to bf16 pairs is the p rounding (l takes p unrounded). Only the first 8
// rows can be query rows, so rows 8 .. 15 of P are zero and never exp'd.
// The warps' (m, l, acc) are merged through shared memory and stored as the
// chunk's partial, which merge_chunks combines.
template <int HD>
__global__ void __launch_bounds__(128)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ q_pos, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int H, int KvH, int S,
                  int64_t stride_b, int64_t stride_h, float scale,
                  float softcap, int window, int chunk) {
  constexpr int NW = 4;
  constexpr int LD = HD + 8;       // bf16 per staged row: +16 bytes
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks a row
  constexpr int KSTEPS = HD / 16;  // k16 steps of Q . K^T
  constexpr int DTILES = HD / 8;   // n8 tiles of the output
  constexpr int NT = TILE / 8;     // n8 tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KvH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, row
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int nst = tile_stages(chunk, NW);
  __nv_bfloat16* Qs = (__nv_bfloat16*)smem;  // [16][LD]
  __nv_bfloat16* tiles = Qs + 16 * LD;
  // warp w, stage st: K tile at (w * nst + st) * 2 * TILE * LD, V after it
  __nv_bfloat16* mine = tiles + (size_t)warp * nst * 2 * TILE * LD;

  const int64_t run_e =
      (((int64_t)b * gridDim.z + blockIdx.z) * KvH + kvh) * G;
  int lo, hi;
  if (!chunk_rows(q_pos[b], S, window, chunk, blockIdx.z, lo, hi)) {
    if (threadIdx.x < G) {  // no live row in this chunk: a partial of 0
      part_ml[(run_e + threadIdx.x) * 2] = NEG_INF;
      part_ml[(run_e + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }
  const int ntiles = (hi - lo) / TILE + 1;
  const int64_t base = (int64_t)b * stride_b + (int64_t)kvh * stride_h;

  for (int c = threadIdx.x; c < 16 * CHUNKS; c += blockDim.x) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    cp_async16_zfill(Qs + r * LD + col,
                     q + ((int64_t)b * H + kvh * G + min(r, G - 1)) * HD + col,
                     r < G ? 16 : 0);
  }
  cp_async_commit();

  auto stage = [&](int t, int st) {
    const int k0 = lo + t * TILE;
    __nv_bfloat16* kt = mine + (size_t)st * 2 * TILE * LD;
    __nv_bfloat16* vt = kt + TILE * LD;
    for (int idx = lane; idx < TILE * CHUNKS; idx += 32) {
      const int r = idx / CHUNKS, col = (idx % CHUNKS) * 8;
      const int64_t off = base + (int64_t)min(k0 + r, hi) * HD + col;
      const int n = k0 + r <= hi ? 16 : 0;
      cp_async16_zfill(kt + r * LD + col, k + off, n);
      cp_async16_zfill(vt + r * LD + col, v + off, n);
    }
  };

  int t = warp;
  if (t < ntiles) stage(t, 0);
  cp_async_commit();
  cp_async_wait<1>();  // this thread's copies of Q have landed
  __syncthreads();     // ... and every thread's
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int st = 0; st < KSTEPS; ++st)
    ldmatrix_x4(qf[st], Qs + (lane & 15) * LD + st * 16 + (lane >> 4) * 8);

  float o[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m_r = NEG_INF, l_r = 0.f;  // this lane's query row g

  for (int it = 0; t < ntiles; ++it, t += NW) {
    if (t + NW < ntiles) {
      stage(t + NW, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const __nv_bfloat16* kt = mine + (size_t)(it & 1) * 2 * TILE * LD;
    const __nv_bfloat16* vt = kt + TILE * LD;
    const int k0 = lo + t * TILE;

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
        ldmatrix_x4(kb, kt + (np * 16 + mr + 8 * (mi >> 1)) * LD + st * 16 +
                            8 * (mi & 1));
        mma_bf16(s[2 * np], qf[st], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[st], kb[2], kb[3]);
      }
    }

    // row g's scores (accumulators 0 and 1 of each n-tile): scaled,
    // soft-capped, keys past hi masked
    float mx = NEG_INF;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (k0 + n * 8 + 2 * t4 + e > hi) x = NEG_INF;
        s[n][e] = x;
        mx = fmaxf(mx, x);
      }
    }
    const float m_new = fmaxf(m_r, quad_max(mx));
    const float alpha = __expf(m_r - m_new);
    m_r = m_new;

    // p = exp(s - m) as bf16 A fragments of P . V (k16 step j takes the
    // key n-tiles 2j and 2j + 1; rows 8 .. 15 zero); l sums p unrounded
    uint32_t pf[NT / 2][4];
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = __expf(s[n][0] - m_new);
      const float p1 = __expf(s[n][1] - m_new);
      psum += p0 + p1;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = 0u;
    }
    l_r = l_r * alpha + quad_sum(psum);
#pragma unroll
    for (int d = 0; d < DTILES; ++d) {
      o[d][0] *= alpha;
      o[d][1] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
#pragma unroll
      for (int dp = 0; dp < DTILES / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (j * 16 + mr + 8 * (mi & 1)) * LD +
                                  dp * 16 + 8 * (mi >> 1));
        mma_bf16(o[2 * dp], pf[j], vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pf[j], vb[2], vb[3]);
      }
    }
    __syncwarp();  // this stage is read before it is staged again
  }
  cp_async_wait<0>();

  // merge the warps' states through shared memory (the tiles are free):
  // M = max m_w, L = sum l_w e_w, A = sum acc_w e_w, e_w = exp(m_w - M)
  __syncthreads();
  float* Mw = (float*)tiles;   // [NW][8]
  float* Lw = Mw + NW * 8;     // [NW][8]
  float* Aw = Lw + NW * 8;     // [NW][8][HD]
  if (g < G) {
    if (t4 == 0) {
      Mw[warp * 8 + g] = m_r;
      Lw[warp * 8 + g] = l_r;
    }
#pragma unroll
    for (int d = 0; d < DTILES; ++d) {
      float* a = Aw + ((size_t)warp * 8 + g) * HD + d * 8 + 2 * t4;
      a[0] = o[d][0];
      a[1] = o[d][1];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
    const int gg = idx / HD, d = idx - gg * HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * 8 + gg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = __expf(Mw[w * 8 + gg] - M);
      L = fmaf(Lw[w * 8 + gg], e, L);
      A = fmaf(Aw[((size_t)w * 8 + gg) * HD + d], e, A);
    }
    part_acc[(run_e + gg) * HD + d] = A;
    if (d == 0) {
      part_ml[(run_e + gg) * 2] = M;
      part_ml[(run_e + gg) * 2 + 1] = L;
    }
  }
}

// Warps a CTA: two staged tiles a warp must fit in shared memory.
inline int warps_for(int hd) { return hd <= 128 ? 4 : 2; }

// Dynamic shared memory of a launch with nst staged tiles a warp: the G
// query rows, the warps' p rows and their staged K/V tiles (the merge at
// the end reuses the tiles), laid out as decode_kernel<MAXG> reads them.
template <int MAXG>
size_t smem_bytes(int G, int hd, int nst) {
  const int nw = warps_for(hd);
  return sizeof(float) * ((size_t)G * hd + (size_t)nw * MAXG * TILE) +
         (size_t)nw * nst * 2 * TILE * tile_pitch(hd);
}

bool valid(int H, int KvH, int maxg, int hd, int S, int chunk) {
  return KvH > 0 && H % KvH == 0 && H / KvH <= maxg && hd % 8 == 0 &&
         hd <= MAX_HD && S >= 1 && chunk > 0 && chunk % TILE == 0;
}

// The scalar kernel (K3, and K2 at a head dim the tensor-core kernel does
// not take): partials, then their merge.
template <int MAXG>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           void* out, float* part_acc, float* part_ml, int B, int H, int KvH,
           int S, int hd, long long stride_b, long long stride_h, float scale,
           float softcap, int window, int chunk, void* stream) {
  const int G = H / KvH;
  if (!valid(H, KvH, MAXG, hd, S, chunk)) return (int)cudaErrorInvalidValue;
  // the shared memory cap is raised once per instantiation, to what its
  // largest launch needs (every hd it takes), not on every launch
  static const cudaError_t cap = [] {
    size_t most = 0;
    for (int d = 8; d <= MAX_HD; d += 8) {
      const size_t need = smem_bytes<MAXG>(MAXG, d, 2);
      most = most > need ? most : need;
    }
    return cudaFuncSetAttribute(decode_kernel<MAXG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)most);
  }();
  if (cap != cudaSuccess) return (int)cap;
  const int nchunk = (S + chunk - 1) / chunk;
  const int nw = warps_for(hd);
  decode_kernel<MAXG><<<dim3(KvH, B, nchunk), 32 * nw,
                        smem_bytes<MAXG>(G, hd, tile_stages(chunk, nw)),
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, q_pos, part_acc, part_ml, H, KvH, S, hd,
      (int64_t)stride_b, (int64_t)stride_h, scale, softcap, window, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(part_acc, part_ml, out, B, H, KvH, hd, nchunk,
                      (cudaStream_t)stream);
}

// Dynamic shared memory of decode_mma_kernel with nst staged tiles a warp:
// Q's 16 rows and the four warps' staged K/V tiles (the merge at the end
// reuses the tiles).
inline size_t mma_smem_bytes(int hd, int nst) {
  return sizeof(__nv_bfloat16) * (size_t)(hd + 8) * (16 + 4 * nst * 2 * TILE);
}

// The tensor-core kernel (K2 at hd a multiple of 16 up to 128): partials,
// then their merge.
template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const int* q_pos,
               void* out, float* part_acc, float* part_ml, int B, int H,
               int KvH, int S, long long stride_b, long long stride_h,
               float scale, float softcap, int window, int chunk,
               void* stream) {
  static const cudaError_t cap = cudaFuncSetAttribute(
      decode_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mma_smem_bytes(HD, 2));
  if (cap != cudaSuccess) return (int)cap;
  const int nchunk = (S + chunk - 1) / chunk;
  decode_mma_kernel<HD><<<dim3(KvH, B, nchunk), 128,
                          mma_smem_bytes(HD, tile_stages(chunk, 4)),
                          (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, q_pos, part_acc, part_ml, H, KvH, S,
      (int64_t)stride_b, (int64_t)stride_h, scale, softcap, window, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(part_acc, part_ml, out, B, H, KvH, HD, nchunk,
                      (cudaStream_t)stream);
}

}  // namespace

// GQA decode (K2). q [B, 1, H, hd] bf16 contiguous; k/v bf16 rows of hd
// contiguous elements, row j of (b, h) at b * stride_b + h * stride_h +
// j * hd (16-byte aligned: the wrapper checks); S rows per (b, h); q_pos [B]
// int32; out [B, 1, H, hd] bf16. H % KvH == 0, H / KvH <= 8, hd % 8 == 0,
// hd <= 256. The rows are split in chunks of ``chunk`` (a positive
// multiple of 32); part_acc [B * nchunk, KvH, H / KvH, hd] and part_ml
// [B * nchunk, KvH, H / KvH, 2] f32 hold the partials, nchunk =
// ceil(S / chunk). Two launches on ``stream`` (partials, merge). Returns
// cudaGetLastError() (cudaErrorInvalidValue, and no launch, for a shape or
// chunk it does not take).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const int* q_pos,
                                     void* out, void* part_acc,
                                     void* part_ml, int B, int H, int KvH,
                                     int S, int hd, long long stride_b,
                                     long long stride_h, float scale,
                                     float softcap, int window, int chunk,
                                     void* stream) {
  if (!valid(H, KvH, 8, hd, S, chunk)) return (int)cudaErrorInvalidValue;
  switch (hd) {
#define HD_CASE(n)                                                          \
  case n:                                                                   \
    return launch_mma<n>(q, k, v, q_pos, out, (float*)part_acc,             \
                         (float*)part_ml, B, H, KvH, S, stride_b, stride_h, \
                         scale, softcap, window, chunk, stream);
    HD_CASE(16) HD_CASE(32) HD_CASE(48) HD_CASE(64)
    HD_CASE(80) HD_CASE(96) HD_CASE(112) HD_CASE(128)
#undef HD_CASE
    default:
      break;
  }
  return launch<8>(q, k, v, q_pos, out, (float*)part_acc, (float*)part_ml,
                   B, H, KvH, S, hd, stride_b, stride_h, scale, softcap,
                   window, chunk, stream);
}

// MHA decode (K3): the same arguments with KvH == H (one query row a CTA).
extern "C" int mha_decode_bf16(const void* q, const void* k, const void* v,
                               const int* q_pos, void* out, void* part_acc,
                               void* part_ml, int B, int H, int S, int hd,
                               long long stride_b, long long stride_h,
                               float scale, float softcap, int window,
                               int chunk, void* stream) {
  return launch<1>(q, k, v, q_pos, out, (float*)part_acc, (float*)part_ml,
                   B, H, H, S, hd, stride_b, stride_h, scale, softcap, window,
                   chunk, stream);
}
