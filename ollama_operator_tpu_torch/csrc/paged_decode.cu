// Single-token GQA attention over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel ollama_operator_tpu/ops/pallas/paged.py ::
// paged_decode_attention_v3 (kernel body _paged_kernel_v3, with
// _flash_page_update and _prep_paged). Same function: for each slot b the
// query at absolute position lengths[b] attends keys 0 .. lengths[b]
// (inclusive) through the slot's block table, optionally only inside a
// sliding window; scores are scaled, softcapped, then masked; f32 online
// softmax. For an int8 or int4 pool the per-position key scale multiplies
// the scores and the value scale folds into the probabilities, so no
// dequantized K/V tile is ever written anywhere.
//
// What bounds it on the card: bytes. Each live page is read once per
// (slot, kv head): ps * hd code bytes for K and for V (half that for int4),
// plus 2 * ps f32 scales, against G * ps * hd * 2 multiply-adds, i.e. a few
// operations per byte for G = 3 or 4, far below the card's ~295 operations
// per byte.
//
// Design: one CTA of 128 threads per (kv head, slot) computes the G query
// rows of that group. The CTA reads its own block-table row and length in
// place of the TPU's scalar prefetch and walks only the live pages
// [start, lengths[b] / ps] (start from the window). Per page it stages K and
// V with coalesced 4-byte loads (K rows padded by one word so the per-key
// row walk is conflict-free); thread j scores key j against the G rows,
// block reductions give the page max and sum, and thread d accumulates
// output column d (and d + 128) for the G rows. The layer index is a plain
// argument, so the full [L, P, ...] pool is addressed in place.
//
// int4 pool: byte row j of a page holds positions 2j (low nibble) and
// 2j + 1 (high nibble), each as nibble - 8 (the TPU kernel's _unpack4).
// The staging loop reads the packed page (half the int8 bytes) and writes
// both positions' codes into shared memory as int8 rows, so everything
// after staging is the int8 variant's code.
//
// Pool layout of the port: codes [L, P, KvH, ps, hd] (int8 or bf16) or
// [L, P, KvH, ps/2, hd] (int4, uint8) with the true head dim (no padding),
// scales [L, P, KvH, ps] f32 unpadded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_G = 8;
constexpr int MAX_NC = 2;  // output columns per thread: hd <= 256
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

template <typename T, bool QUANT, bool PACK4>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kpool,
                    const float* __restrict__ kscale,
                    const T* __restrict__ vpool,
                    const float* __restrict__ vscale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int H, int KvH, int hd,
                    int P, int ps, int nblk, int layer, float scale,
                    float softcap, int window) {
  constexpr int EPW = 4 / sizeof(T);  // elements per 32-bit word
  extern __shared__ float smem[];
  const int G = H / KvH;
  const int nw = hd / EPW;   // words per K/V row
  const int ldk = nw + 1;    // padded K row pitch, in words
  float* qs = smem;                                        // [G][hd]
  uint32_t* Kw = (uint32_t*)(qs + G * hd);                 // [ps][nw + 1]
  uint32_t* Vw = Kw + ps * ldk;                            // [ps][nw]
  float* kss = (float*)(Vw + ps * nw);                     // [ps]
  float* vss = kss + ps;                                   // [ps]
  float* Pg = vss + ps;                                    // [G][ps]
  float* red = Pg + G * ps;                                // [MAX_G][NWARPS]
  const T* Vs = (const T*)Vw;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int qp = lengths[b];
  int nlive = qp / ps + 1;
  if (nlive > nblk) nlive = nblk;
  int start = 0;
  if (window > 0) {
    const int lo = (qp - window + 1) / ps;
    if (lo > 0) start = lo;
  }

  for (int idx = tid; idx < G * hd; idx += NTHREADS) {
    const int g = idx / hd, d = idx - g * hd;
    qs[idx] = __bfloat162float(q[((int64_t)b * H + kvh * G + g) * hd + d]);
  }

  float m[MAX_G], l[MAX_G], acc[MAX_G][MAX_NC];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < MAX_NC; ++c) acc[g][c] = 0.f;
  }

  for (int i = start; i < nlive; ++i) {
    const int page = tables[(int64_t)b * nblk + i];
    const int64_t row0 = (((int64_t)layer * P + page) * KvH + kvh) * ps;
    // code rows of this page: ps, or ps / 2 packed rows for int4
    const int64_t crow0 = PACK4 ? row0 / 2 : row0;
    const uint32_t* kg = (const uint32_t*)(kpool + crow0 * hd);
    const uint32_t* vg = (const uint32_t*)(vpool + crow0 * hd);
    __syncthreads();  // q staged (first page) / previous page consumed
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
      kss[tid] = kscale[row0 + tid];
      vss[tid] = vscale[row0 + tid];
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
            if (g < G) s[g] = fmaf(qs[g * hd + d], kv[e], s[g]);
        }
      }
    }
    const int pos = i * ps + j;
    bool ok = (j < ps) && (pos <= qp);
    if (window > 0) ok = ok && (pos > qp - window);
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      float x = s[g] * scale;
      if (QUANT) x = x * (j < ps ? kss[j] : 0.f);
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      s[g] = ok ? x : NEG_INF;
    }

    float mx[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) mx[g] = s[g];
    block_reduce<true>(mx, G, red);
    float alpha[MAX_G], p[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      const float m_new = fmaxf(m[g], mx[g]);
      alpha[g] = expf(m[g] - m_new);
      p[g] = (ok && m_new > NEG_INF * 0.5f) ? expf(s[g] - m_new) : 0.f;
      m[g] = m_new;
    }
    if (j < ps) {
      const float vsc = QUANT ? vss[j] : 1.f;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) Pg[g * ps + j] = p[g] * vsc;
    }
    block_reduce<false>(p, G, red);  // also orders the Pg writes
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) l[g] = l[g] * alpha[g] + p[g];

#pragma unroll
    for (int c = 0; c < MAX_NC; ++c) {
      const int d = tid + NTHREADS * c;
      if (d < hd) {
        float a[MAX_G];
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) a[g] = acc[g][c] * alpha[g];
        for (int jj = 0; jj < ps; ++jj) {
          const float vv = load_elem<T>(Vs + jj * hd + d);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) a[g] = fmaf(Pg[g * ps + jj], vv, a[g]);
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) acc[g][c] = a[g];
      }
    }
  }

#pragma unroll
  for (int c = 0; c < MAX_NC; ++c) {
    const int d = tid + NTHREADS * c;
    if (d >= hd) continue;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float o = acc[g][c] / fmaxf(l[g], 1e-30f);
        out[((int64_t)b * H + kvh * G + g) * hd + d] = __float2bfloat16(o);
      }
    }
  }
}

template <typename T, bool QUANT, bool PACK4>
int launch(const void* q, const void* kpool, const void* kscale,
           const void* vpool, const void* vscale, const int* tables,
           const int* lengths, void* out, int B, int H, int KvH, int hd,
           int P, int ps, int nblk, int layer, float scale, float softcap,
           int window, void* stream) {
  const int G = H / KvH;
  const int nw = hd * (int)sizeof(T) / 4;
  const size_t smem = sizeof(float) * ((size_t)G * hd + (size_t)ps * (nw + 1) +
                                       (size_t)ps * nw + 2 * (size_t)ps +
                                       (size_t)G * ps + MAX_G * NWARPS);
  cudaFuncSetAttribute(paged_decode_kernel<T, QUANT, PACK4>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(KvH, B);
  paged_decode_kernel<T, QUANT, PACK4>
      <<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const T*)kpool, (const float*)kscale,
      (const T*)vpool, (const float*)vscale, tables, lengths,
      (__nv_bfloat16*)out, H, KvH, hd, P, ps, nblk, layer, scale, softcap,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, 1, H, hd] bf16; pools [L, P, KvH, ps, hd] int8 with scales
// [L, P, KvH, ps] f32; tables [B, nblk] int32; lengths [B] int32 (the
// query's absolute position); out [B, 1, H, hd] bf16. All contiguous.
// The wrapper checks H % KvH == 0, H / KvH <= 8, ps <= 128, hd % 4 == 0 and
// hd <= 256. Returns cudaGetLastError().
extern "C" int paged_decode_int8(const void* q, const void* kq,
                                 const void* ks, const void* vq,
                                 const void* vs, const int* tables,
                                 const int* lengths, void* out, int B, int H,
                                 int KvH, int hd, int P, int ps, int nblk,
                                 int layer, float scale, float softcap,
                                 int window, void* stream) {
  return launch<int8_t, true, false>(q, kq, ks, vq, vs, tables, lengths, out,
                                     B, H, KvH, hd, P, ps, nblk, layer, scale,
                                     softcap, window, stream);
}

// The same for an int4 pool: codes [L, P, KvH, ps/2, hd] uint8 (positions
// 2j and 2j + 1 in the low and high nibbles of row j, +8 bias), scales
// [L, P, KvH, ps] f32. ps is the logical page size and must be even.
extern "C" int paged_decode_int4(const void* q, const void* kq4,
                                 const void* ks, const void* vq4,
                                 const void* vs, const int* tables,
                                 const int* lengths, void* out, int B, int H,
                                 int KvH, int hd, int P, int ps, int nblk,
                                 int layer, float scale, float softcap,
                                 int window, void* stream) {
  if (ps % 2) return (int)cudaErrorInvalidValue;
  return launch<int8_t, true, true>(q, kq4, ks, vq4, vs, tables, lengths, out,
                                    B, H, KvH, hd, P, ps, nblk, layer, scale,
                                    softcap, window, stream);
}

// The same for a bf16 pool (no scales).
extern "C" int paged_decode_bf16(const void* q, const void* kp,
                                 const void* vp, const int* tables,
                                 const int* lengths, void* out, int B, int H,
                                 int KvH, int hd, int P, int ps, int nblk,
                                 int layer, float scale, float softcap,
                                 int window, void* stream) {
  return launch<__nv_bfloat16, false, false>(q, kp, nullptr, vp, nullptr,
                                             tables, lengths, out, B, H, KvH,
                                             hd, P, ps, nblk, layer, scale,
                                             softcap, window, stream);
}
