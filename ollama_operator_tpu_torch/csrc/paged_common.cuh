// Shared code of the three paged-decode kernels (paged_decode.cu,
// paged_decode_v2.cu, paged_decode_v4.cu), for Hopper (sm_90a).
//
// The function all three compute: for each slot b the query at absolute
// position lengths[b] attends keys 0 .. lengths[b] (inclusive) through the
// slot's block table, optionally only inside a sliding window; scores are
// scaled, multiplied by the key scale (int8/int4 pools), softcapped, then
// masked; f32 online softmax page by page; the probabilities times the value
// scale are rounded to bf16 before the p . v product (as the TPU kernels'
// bf16 dot does), while the sum l takes the unrounded probabilities.
//
// One CTA of NTHREADS threads works on one (kv head, slot) pair at a time,
// for the G = H / KvH query rows of the group. Per page it stages K and V
// with coalesced 4-byte loads (K rows padded by one word so the per-key
// row walk is conflict-free); thread j scores key j against the G rows,
// block reductions give the page max and sum, and thread d accumulates
// output column d (and d + NTHREADS) for the G rows in registers.
//
// int4 pool: byte row j of a page holds positions 2j (low nibble) and
// 2j + 1 (high nibble), each as nibble - 8 (the TPU kernel's _unpack4).
// The staging loop reads the packed page (half the int8 bytes) and writes
// both positions' codes into shared memory as int8 rows, so everything
// after staging is the int8 code.
//
// Pool layout of the port: codes [L, P, KvH, ps, hd] (int8 or bf16) or
// [L, P, KvH, ps/2, hd] (int4, uint8) with the true head dim (no padding),
// scales [L, P, KvH, ps] f32 unpadded; tables [B, NBLK] int32.
//
// All three store a partial state (m, l, acc) per run of consecutive rows
// of one slot, and a second pass merges a slot's partials in a fixed order,
// so a repeat gives the same bits (split_decode.cuh merge_run). Their
// tensor-core tile loop is in paged_tiles.cuh; the scalar page loop below
// (page_update) serves only the head dims it does not take.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_G = 8;       // the scalar page loop's largest group
constexpr int MAX_G_MMA = 16;  // the tensor-core tile loop's (paged_tiles)
constexpr int MAX_NC = 2;  // output columns per thread: hd <= 256
constexpr float NEG_INF = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const void* kpool;
  const float* kscale;
  const void* vpool;
  const float* vscale;
  const int* tables;
  const int* lengths;
  __nv_bfloat16* out;
  int B, H, KvH, hd, P, ps, NBLK, nblk, layer;
  float scale, softcap;
  int window;
};

// The entries' plain C arguments as Params.
inline Params make_params(const void* q, const void* kq, const void* ks,
                          const void* vq, const void* vs, const int* tables,
                          const int* lengths, void* out, int B, int H,
                          int KvH, int hd, int P, int ps, int NBLK, int nblk,
                          int layer, float scale, float softcap, int window) {
  return Params{(const __nv_bfloat16*)q, kq, (const float*)ks, vq,
                (const float*)vs, tables, lengths, (__nv_bfloat16*)out,
                B, H, KvH, hd, P, ps, NBLK, nblk, layer, scale, softcap,
                window};
}

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

// Reduce vals[g] for g < G over the whole block; every thread gets the
// result. ``red`` holds MAX_G * NWARPS floats.
template <bool IS_MAX>
__device__ __forceinline__ void block_reduce(float (&vals)[MAX_G], int G,
                                             float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      const float r = IS_MAX ? warp_max(vals[g]) : warp_sum(vals[g]);
      if (lane == 0) red[g * NWARPS + warp] = r;
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      float r = red[g * NWARPS];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w)
        r = IS_MAX ? fmaxf(r, red[g * NWARPS + w]) : r + red[g * NWARPS + w];
      vals[g] = r;
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void unpack_word(uint32_t w, float* out);

template <>
__device__ __forceinline__ void unpack_word<int8_t>(uint32_t w, float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (float)(int8_t)((w >> (8 * i)) & 0xffu);
}

template <>
__device__ __forceinline__ void unpack_word<__nv_bfloat16>(uint32_t w,
                                                           float* out) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ float load_elem(const T* p);

template <>
__device__ __forceinline__ float load_elem<int8_t>(const int8_t* p) {
  return (float)*p;
}

template <>
__device__ __forceinline__ float load_elem<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Four packed int4 bytes → the four low-nibble codes and the four
// high-nibble codes, each as four int8 in a word (nibble - 8, byte-wise).
__device__ __forceinline__ void unpack_int4_word(uint32_t w, uint32_t& lo,
                                                 uint32_t& hi) {
  lo = __vsub4(w & 0x0f0f0f0fu, 0x08080808u);
  hi = __vsub4((w >> 4) & 0x0f0f0f0fu, 0x08080808u);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Dynamic shared memory of the Smem layout, in floats/words, for element
// size ``esize`` of the staged codes (1: int8/int4, 2: bf16).
__host__ __device__ inline size_t smem_floats(int G, int hd, int ps,
                                              int esize) {
  const size_t nw = (size_t)hd * esize / 4;
  return (size_t)G * hd + (size_t)ps * (nw + 1) + (size_t)ps * nw +
         2 * (size_t)ps + (size_t)G * ps + MAX_G * NWARPS;
}

struct Smem {
  float* qs;     // [G][hd]
  uint32_t* Kw;  // [ps][nw + 1]
  uint32_t* Vw;  // [ps][nw]
  float* kss;    // [ps]
  float* vss;    // [ps]
  float* Pg;     // [G][ps]
  float* red;    // [MAX_G][NWARPS]
  float* end;    // first float past this layout
  int nw;
  __device__ Smem(float* base, int G, int hd, int ps, int esize) {
    nw = hd * esize / 4;
    qs = base;
    Kw = (uint32_t*)(qs + G * hd);
    Vw = Kw + ps * (nw + 1);
    kss = (float*)(Vw + ps * nw);
    vss = kss + ps;
    Pg = vss + ps;
    red = Pg + G * ps;
    end = red + MAX_G * NWARPS;
  }
};

struct State {
  float m[MAX_G], l[MAX_G], acc[MAX_G][MAX_NC];
};

__device__ __forceinline__ void init_state(State& st) {
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    st.m[g] = NEG_INF;
    st.l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_NC; ++c) st.acc[g][c] = 0.f;
  }
}

// Stage the G query rows of (slot b, kv head kvh) as f32. Callers order it
// before the next scoring with the __syncthreads that opens page_update;
// the previous page's scoring is over by then (its block reductions).
__device__ __forceinline__ void load_q(const Params& a, const Smem& sm, int G,
                                       int b, int kvh) {
  for (int idx = threadIdx.x; idx < G * a.hd; idx += NTHREADS) {
    const int g = idx / a.hd, d = idx - g * a.hd;
    sm.qs[idx] =
        __bfloat162float(a.q[((int64_t)b * a.H + kvh * G + g) * a.hd + d]);
  }
}

// Fold logical block ``blk`` of slot b (query position qp) for kv head kvh
// into the running state: stage the page, score, mask, online softmax,
// p . v. Every thread of the CTA calls it.
template <typename T, bool QUANT, bool PACK4>
__device__ __forceinline__ void page_update(const Params& a, const Smem& sm,
                                            State& st, int G, int b, int kvh,
                                            int blk, int qp) {
  constexpr int EPW = 4 / sizeof(T);  // elements per 32-bit word
  const int tid = threadIdx.x;
  const int ps = a.ps, hd = a.hd, nw = sm.nw, ldk = nw + 1;
  const T* kpool = (const T*)a.kpool;
  const T* vpool = (const T*)a.vpool;
  const int page = a.tables[(int64_t)b * a.NBLK + blk];
  const int64_t row0 = (((int64_t)a.layer * a.P + page) * a.KvH + kvh) * ps;
  // code rows of this page: ps, or ps / 2 packed rows for int4
  const int64_t crow0 = PACK4 ? row0 / 2 : row0;
  const uint32_t* kg = (const uint32_t*)(kpool + crow0 * hd);
  const uint32_t* vg = (const uint32_t*)(vpool + crow0 * hd);
  uint32_t* Kw = sm.Kw;
  uint32_t* Vw = sm.Vw;
  __syncthreads();  // q staged / previous page consumed
  if (PACK4) {
    for (int idx = tid; idx < (ps / 2) * nw; idx += NTHREADS) {
      const int r = idx / nw, w = idx - r * nw;
      uint32_t lo, hi;
      unpack_int4_word(kg[idx], lo, hi);
      Kw[(2 * r) * ldk + w] = lo;
      Kw[(2 * r + 1) * ldk + w] = hi;
      unpack_int4_word(vg[idx], lo, hi);
      Vw[(2 * r) * nw + w] = lo;
      Vw[(2 * r + 1) * nw + w] = hi;
    }
  } else {
    for (int idx = tid; idx < ps * nw; idx += NTHREADS) {
      const int r = idx / nw, w = idx - r * nw;
      Kw[r * ldk + w] = kg[idx];
      Vw[idx] = vg[idx];
    }
  }
  if (QUANT && tid < ps) {
    sm.kss[tid] = a.kscale[row0 + tid];
    sm.vss[tid] = a.vscale[row0 + tid];
  }
  __syncthreads();

  float s[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
  const int j = tid;
  if (j < ps) {
    for (int w = 0; w < nw; ++w) {
      float kv[EPW];
      unpack_word<T>(Kw[j * ldk + w], kv);
#pragma unroll
      for (int e = 0; e < EPW; ++e) {
        const int d = w * EPW + e;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) s[g] = fmaf(sm.qs[g * hd + d], kv[e], s[g]);
      }
    }
  }
  const int pos = blk * ps + j;
  bool ok = (j < ps) && (pos <= qp);
  if (a.window > 0) ok = ok && (pos > qp - a.window);
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    float x = s[g] * a.scale;
    if (QUANT) x = x * (j < ps ? sm.kss[j] : 0.f);
    if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
    s[g] = ok ? x : NEG_INF;
  }

  float mx[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) mx[g] = s[g];
  block_reduce<true>(mx, G, sm.red);
  float alpha[MAX_G], p[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    const float m_new = fmaxf(st.m[g], mx[g]);
    alpha[g] = expf(st.m[g] - m_new);
    p[g] = (ok && m_new > NEG_INF * 0.5f) ? expf(s[g] - m_new) : 0.f;
    st.m[g] = m_new;
  }
  if (j < ps) {
    const float vsc = QUANT ? sm.vss[j] : 1.f;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) sm.Pg[g * ps + j] = round_bf16(p[g] * vsc);
  }
  block_reduce<false>(p, G, sm.red);  // also orders the Pg writes
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) st.l[g] = st.l[g] * alpha[g] + p[g];

  const T* Vs = (const T*)Vw;
#pragma unroll
  for (int c = 0; c < MAX_NC; ++c) {
    const int d = tid + NTHREADS * c;
    if (d < hd) {
      float acc[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) acc[g] = st.acc[g][c] * alpha[g];
      for (int jj = 0; jj < ps; ++jj) {
        const float vv = load_elem<T>(Vs + jj * hd + d);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) acc[g] = fmaf(sm.Pg[g * ps + jj], vv, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) st.acc[g][c] = acc[g];
    }
  }
}

// Partials: part_acc [n_part, KvH, G, hd] and part_ml [n_part, KvH, G, 2]
// (m, l) f32, one entry per run of pages ``run``.
__device__ __forceinline__ void store_partial(const Params& a,
                                              const State& st, int G, int run,
                                              int kvh, float* part_acc,
                                              float* part_ml) {
  const int64_t base = ((int64_t)run * a.KvH + kvh) * G;
#pragma unroll
  for (int c = 0; c < MAX_NC; ++c) {
    const int d = threadIdx.x + NTHREADS * c;
    if (d >= a.hd) continue;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) part_acc[(base + g) * a.hd + d] = st.acc[g][c];
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        part_ml[(base + g) * 2] = st.m[g];
        part_ml[(base + g) * 2 + 1] = st.l[g];
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory cap to ``bytes`` the first time a
// launch needs more than it was given (once per kernel instantiation).
template <typename K>
inline void allow_smem(K kernel, size_t bytes, size_t& granted) {
  if (bytes > granted) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    granted = bytes;
  }
}

}  // namespace paged
