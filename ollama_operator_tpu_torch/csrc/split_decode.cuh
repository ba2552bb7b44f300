// Helpers shared by the split single-token attention kernels for Hopper
// (sm_90a): the dense-cache GQA/MHA kernels (decode_attention.cu) and the
// paged kernels (paged_tiles.cuh; merge_run also merges the v4 kernel's
// runs, paged_decode_v4.cu).
//
// - 16-byte (and 4-byte) cp.async copies, zero-filling when src_bytes is 0;
// - ldmatrix and mma.sync (m16n8k16, bf16 in, f32 accumulate) fragments;
// - merge_run, the merge of one query row's partials (m, l, acc) in a
//   fixed order, so a repeat gives the same bits, and merge_chunks, the
//   second launch of a split call: a CTA of each (kv head, slot, query row
//   of the group) merges that row's partials in chunk order.
//
// Partials layout: part_ml [B, nchunk, KvH, G, 2] (m, l) and part_acc
// [B, nchunk, KvH, G, hd], f32; a chunk with no live row stores m = -1e30,
// l = 0 and its acc is never read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace split {

constexpr float NEG_INF = -1e30f;

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

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// 4 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

// two f32 -> one bf16 pair, each rounded to nearest; lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Merge one query row's nz partials, entries e0 + z * z_step (z < nz) of
// part_acc [.., hd] and part_ml [.., 2], in z order into out_row [hd]:
// M = max m, out = sum w acc / max(sum w l, 1e-30), w = exp(m - M), a
// partial with m at NEG_INF weighing 0 and its acc never read; the (m, l)
// of every partial are staged in ``ml`` [nz][2] (shared memory) by one
// pass, and the live ones (a contiguous run: those that hold a row) walked
// without a branch, so each output's loads of acc are independent of one
// another. Every thread of the CTA calls it.
__device__ __forceinline__ void merge_run(const float* __restrict__ part_acc,
                                          const float* __restrict__ part_ml,
                                          __nv_bfloat16* __restrict__ out_row,
                                          int64_t e0, int64_t z_step, int nz,
                                          int hd, float* ml) {
  __shared__ float Ls;
  __shared__ int live[2];
  for (int i = threadIdx.x; i < nz * 2; i += blockDim.x)
    ml[i] = part_ml[(e0 + (i >> 1) * z_step) * 2 + (i & 1)];
  __syncthreads();
  if (threadIdx.x == 0) {
    int z0 = nz, z1 = -1;
    float M = NEG_INF;
    for (int z = 0; z < nz; ++z) {
      if (ml[2 * z] > NEG_INF * 0.5f) {
        z0 = min(z0, z);
        z1 = z;
        M = fmaxf(M, ml[2 * z]);
      }
    }
    float L = 0.f;
    for (int z = z0; z <= z1; ++z) {
      const float w = expf(ml[2 * z] - M);
      L = fmaf(w, ml[2 * z + 1], L);
      ml[2 * z] = w;
    }
    Ls = L;
    live[0] = z0;
    live[1] = z1;
  }
  __syncthreads();
  const int z0 = live[0], z1 = live[1];
  const float den = fmaxf(Ls, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    const float* a = part_acc + e0 * hd + d;
    float num = 0.f;
#pragma unroll 8
    for (int z = z0; z <= z1; ++z)
      num = fmaf(ml[2 * z], a[z * z_step * hd], num);
    out_row[d] = __float2bfloat16(num / den);
  }
}

// Second launch of the split kernels: one CTA per (kv head, slot, query
// row of the group) merges that row's nchunk partials in chunk order
// (merge_run).
__global__ void __launch_bounds__(128)
merge_chunks(const float* __restrict__ part_acc,
             const float* __restrict__ part_ml,
             __nv_bfloat16* __restrict__ out,
             int H, int KvH, int hd, int nchunk) {
  extern __shared__ float ml[];  // [nchunk][2] (m, l); then w over m
  const int kvh = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int G = H / KvH;
  // partial of chunk z: (b * nchunk + z) * KvH * G + kvh * G + g
  merge_run(part_acc, part_ml, out + ((int64_t)b * H + kvh * G + g) * hd,
            ((int64_t)b * nchunk * KvH + kvh) * G + g, (int64_t)KvH * G,
            nchunk, hd, ml);
}

// Second launch of a call: merge_chunks over (kv head, slot, query
// row of the group). The (m, l) of every chunk sit in shared memory; the
// cap is raised past the default 48 KB only for a cache long enough to
// need it.
inline int launch_merge(const float* part_acc, const float* part_ml,
                        void* out, int B, int H, int KvH, int hd, int nchunk,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * nchunk;
  static size_t granted = 48 << 10;
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_chunks, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted = smem;
  }
  merge_chunks<<<dim3(KvH, B, H / KvH), 128, smem, stream>>>(
      part_acc, part_ml, (__nv_bfloat16*)out, H, KvH, hd, nchunk);
  return (int)cudaGetLastError();
}

}  // namespace split
}  // namespace
