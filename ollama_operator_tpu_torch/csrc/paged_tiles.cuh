// The tensor-core tile loop of the paged-decode kernels for Hopper (sm_90a),
// shared by the v3 (paged_decode.cu), v2 (paged_decode_v2.cu) and v4
// (paged_decode_v4.cu) kernels, and the split launch of v3 and v2.
//
// fold_tiles folds a run of 32-position tiles of one slot's live rows
// [lo, hi] for one kv head into a partial (m, l, acc) in f32 with all the
// CTA's warps: the tiles, aligned to 32, go to the warps round robin; a
// warp copies a tile's K and V code rows (each row through its own table
// entry) and scales into its own ring of STAGES shared buffers with
// cp.async (16-byte pieces of raw codes, rows outside [lo, hi] zero-filled),
// so the next tiles' copies are in flight while this one computes. Kᵀ is
// the A operand (keys as the 16 rows of an m16n8k16 tile, the G <= 8 query
// rows as its 8 columns), so a G = 1 group wastes 7/8 of a tile, not 15/16:
// S^T = K . Q^T, then O^T += V^T . P^T. The codes are widened when the
// fragments are built, exactly (int8 and int4 codes are integers bf16
// holds): an int8 byte goes into the mantissa of 2^23 and comes out as f32,
// whose upper half is the bf16 code; an int4 nibble goes into the mantissa
// of bf16 128 and 136 comes off. bf16 pools are read with ldmatrix (.trans
// for V). The S^T fragment times the value scale, packed to bf16 pairs, is
// the p rounding (l sums p unrounded), and movmatrix.trans turns it into
// the B fragment of P^T. The order of a score's steps is the plain
// version's: q . k, x scale, x key scale, softcap, mask. At the end the
// warps' states are merged through shared memory (the rings are free
// then) and stored as one partial.
//
// Inside a 16-key block, the key of mma row r is r for int8 and bf16
// pools, and 2r (r < 8) or 2(r - 8) + 1 for int4, whose byte row j holds
// positions 2j and 2j + 1. The head dims of a k16 step are permuted for the
// code pools (pairs of bytes 0 and 2, 1 and 3 of a lane's word), and so
// are Q's B fragments; the output's dims follow each lane's V words.
//
// The split launch (launch_split): grid (kv head, slot, chunk of ``cp``
// table blocks over the first ``a.nblk`` blocks), each CTA folding its
// chunk's live rows (paged_mma_kernel; at hd not a multiple of 16 the
// scalar page loop of paged_common.cuh, paged_scalar_kernel), then
// merge_chunks (split_decode.cuh) in a second launch. v3 launches it with
// a.nblk = NBLK (the whole table), v2 with the first nblk blocks.
//
// Chosen by measurement on the H100 (hack/paged_v3_variants.py, PERF.md):
// a 2-stage ring and 4 warps a CTA (a 3-stage ring, or 8 warps of one
// stage each, were slower on the int8 and int4 pools), and K, not Q, as
// the 16-row operand (Q's rows as the A operand, the dense-cache kernel's
// layout, was slower at G = 1, 3 and 4).

#pragma once

#include "paged_common.cuh"
#include "split_decode.cuh"

namespace {

using namespace paged;
using split::cp_async16_zfill;
using split::cp_async4_zfill;
using split::cp_async_commit;
using split::cp_async_wait;
using split::ldmatrix_x4;
using split::ldmatrix_x4_trans;
using split::mma_bf16;
using split::pack_bf16;

constexpr int TILE = 32;    // key positions a warp stages and scores at once
constexpr int STAGES = 2;   // tiles a warp's ring holds (copies in flight)
constexpr int MAX_SMEM = 232448;  // a CTA's shared memory on the H100
constexpr unsigned FULL = 0xffffffffu;

// static_for<N>(f) calls f(Int<0>()) .. f(Int<N - 1>()), so a loop over a
// register array (Q's fragments, O's tiles) has compile-time indices even
// where the runtime head dim guards an iteration: the array stays in
// registers (as a plain loop it may not be unrolled, and is then indexed
// in local memory).
template <int V>
struct Int {
  static constexpr int value = V;
};
template <int I, int N>
struct StaticFor {
  template <typename F>
  static __device__ __forceinline__ void run(F& f) {
    f(Int<I>());
    StaticFor<I + 1, N>::run(f);
  }
};
template <int N>
struct StaticFor<N, N> {
  template <typename F>
  static __device__ __forceinline__ void run(F&) {}
};
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  StaticFor<0, N>::run(f);
}

enum Pool { INT8, INT4, BF16 };

// Bytes of one staged code row: an int8 row or a packed int4 row of hd
// bytes, a bf16 row of 2 hd, padded so that the 8 rows (or 8 row-words)
// a fragment load touches fall on distinct banks (a pitch of 4 mod 8 words).
template <int POOL>
__host__ __device__ inline int code_pitch(int hd) {
  if (POOL == BF16) return 2 * hd + 16;
  return hd + (((hd / 16) & 1) ? 32 : 16);
}

// Code rows a tile: 32 positions, 16 packed rows for int4.
template <int POOL>
__host__ __device__ constexpr int tile_rows() {
  return POOL == INT4 ? TILE / 2 : TILE;
}

// One stage of a warp's ring: K rows, V rows, then (code pools) the 32
// positions' key and value scales.
template <int POOL>
__host__ __device__ inline int stage_bytes(int hd) {
  return 2 * tile_rows<POOL>() * code_pitch<POOL>(hd) +
         (POOL == BF16 ? 0 : 2 * TILE * (int)sizeof(float));
}

// Dynamic shared memory of a CTA of nw warps: the rings, reused at the end
// for the warps' (m, l, acc) [nw][8][2 + hd].
template <int POOL>
inline size_t mma_smem_bytes(int hd, int nw) {
  const size_t rings = (size_t)nw * STAGES * stage_bytes<POOL>(hd);
  const size_t merge = sizeof(float) * nw * 8 * (2 + (size_t)hd);
  return rings > merge ? rings : merge;
}

// Warps a CTA: four, or two where four rings would not fit (bf16, hd >= 224).
template <int POOL>
inline int mma_warps(int hd) {
  return mma_smem_bytes<POOL>(hd, 4) <= MAX_SMEM ? 4 : 2;
}

// The live rows [lo, hi] of chunk z (blocks [z * cp, (z + 1) * cp)) for a
// query at qp, within the attended blocks [0, a.nblk): false when there are
// none (ops/paged.py paged_chunk_blocks states the same plan in blocks).
// cp <= 0 gives the slot's live rows over all attended blocks (the v4
// kernel's list). The split entries refuse cp <= 0, so there the test
// below always holds; without it ptxas (CUDA 12.8) allocates the int4
// tensor-core kernel's registers otherwise and spills 4 bytes.
__device__ __forceinline__ bool chunk_rows(const Params& a, int qp, int cp,
                                           int z, int& lo, int& hi) {
  lo = a.window > 0 && qp - a.window + 1 > 0 ? qp - a.window + 1 : 0;
  hi = min(qp, a.nblk * a.ps - 1);
  if (cp > 0) {
    const int rows = cp * a.ps;
    lo = max(lo, z * rows);
    hi = min(hi, z * rows + rows - 1);
  }
  return lo <= hi;
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(r)
               : "r"(x));
  return r;
}

// int8 codes whose sign bits were flipped (the byte is code + 128): byte sa
// of ua and byte sb of ub -> a bf16 pair, the first in the low half. The
// byte goes into the mantissa of 2^23 and 2^23 + 128 comes off exactly; the
// f32 code (|code| <= 128) has its low 16 bits zero, so its upper half is
// the bf16 code.
__device__ __forceinline__ uint32_t i8_pair(uint32_t ua, uint32_t sa,
                                            uint32_t ub, uint32_t sb) {
  const float fa =
      __uint_as_float(__byte_perm(ua, 0x4B000000u, 0x7540u | sa)) -
      8388736.f;
  const float fb =
      __uint_as_float(__byte_perm(ub, 0x4B000000u, 0x7540u | sb)) -
      8388736.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

// The nibbles at bits sh..sh+3 and 16+sh..16+sh+3 of x -> the bf16 pair of
// their int4 codes (nibble - 8): the nibble goes into the mantissa of bf16
// 128 (0x4300) and 136 comes off exactly.
__device__ __forceinline__ uint32_t i4_pair(uint32_t x, int sh) {
  const uint32_t v = ((x >> sh) & 0x000F000Fu) | 0x43004300u;
  const uint32_t c136 = 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&c136));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The head dim of output row g (g < 8; row g + 8 is the next dim for the
// code pools, 8 dims on for bf16) of m16 tile i. Code pools: lane g's V
// words are g + 8j (j < hd / 32), word j feeding tiles 2j and 2j + 1, and,
// when hd % 32 == 16, the half-word of dims hd - 16 + 2g feeding the last.
template <int POOL>
__device__ __forceinline__ int out_dim(int i, int g, int hd) {
  if (POOL == BF16) return 16 * i + g;
  return (i >> 1) < hd / 32 ? 32 * (i >> 1) + 4 * g + 2 * (i & 1)
                            : 32 * (hd / 32) + 2 * g;
}

// A fragments of V^T (dims x the 16 keys of block kb) for m16 tiles 2j and
// 2j + 1 from the code words w (rows kb's keys, see the header) at lane g's
// word j: int8 rows 2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9; int4 packed rows 2t4
// and 2t4 + 1 (keys 4t4 and 4t4 + 1, 4t4 + 2 and 4t4 + 3).
template <int POOL>
__device__ __forceinline__ void v_frags(const uint32_t (&w)[4],
                                        uint32_t (&a0)[4], uint32_t (&a1)[4]) {
  if (POOL == INT8) {
    const uint32_t r0 = w[0] ^ 0x80808080u, r1 = w[1] ^ 0x80808080u;
    const uint32_t r2 = w[2] ^ 0x80808080u, r3 = w[3] ^ 0x80808080u;
    a0[0] = i8_pair(r0, 0, r1, 0);
    a0[1] = i8_pair(r0, 1, r1, 1);
    a0[2] = i8_pair(r2, 0, r3, 0);
    a0[3] = i8_pair(r2, 1, r3, 1);
    a1[0] = i8_pair(r0, 2, r1, 2);
    a1[1] = i8_pair(r0, 3, r1, 3);
    a1[2] = i8_pair(r2, 2, r3, 2);
    a1[3] = i8_pair(r2, 3, r3, 3);
  } else {
    const uint32_t x0 = __byte_perm(w[0], w[1], 0x5410);
    const uint32_t x1 = __byte_perm(w[0], w[1], 0x7632);
    a0[0] = i4_pair(x0, 0);
    a0[1] = i4_pair(x0, 8);
    a0[2] = i4_pair(x0, 4);
    a0[3] = i4_pair(x0, 12);
    a1[0] = i4_pair(x1, 0);
    a1[1] = i4_pair(x1, 8);
    a1[2] = i4_pair(x1, 4);
    a1[3] = i4_pair(x1, 12);
  }
}

// The heads, head dims and pages the paged-decode entries take (ops/paged.py
// paged_shape_error states the same limits): H % KvH == 0 with H / KvH <=
// 8, hd % 4 == 0 and hd <= 256, 1 <= ps <= 128 (even for int4), and an
// attended width 1 <= nblk <= NBLK.
inline bool paged_shape_ok(int B, int H, int KvH, int hd, int ps, bool pack4,
                           int NBLK, int nblk) {
  return B >= 1 && KvH > 0 && H % KvH == 0 && H / KvH <= MAX_G &&
         hd % 4 == 0 && hd <= 256 && ps >= 1 && ps <= 128 &&
         !(pack4 && ps % 2) && nblk >= 1 && nblk <= NBLK;
}

// The head dims the paged kernels run on the tensor cores (fold_tiles);
// the others take the scalar page loop.
inline int paged_tensor_cores(int hd) {
  return hd > 0 && hd % 16 == 0 && hd <= 256;
}

// Fold slot b's tiles [T0 + TILE t for t < ntiles] (T0 a multiple of TILE)
// for kv head kvh, masked to its live rows [lo, hi], into the partial at
// entry run_e of part_acc [runs, KvH, G, hd] and part_ml [runs, KvH, G, 2]
// (its G query rows at run_e .. run_e + G - 1), with every warp of the CTA
// (hd a multiple of 16 up to MAXHD); ``smem`` holds mma_smem_bytes. Every
// thread of the CTA calls it; a caller that calls it again first orders
// the last call's reads of ``smem`` with a __syncthreads.
template <int MAXHD, int POOL>
__device__ __forceinline__ void fold_tiles(const Params& a, int b, int kvh,
                                           int lo, int hi, int T0,
                                           int ntiles, int64_t run_e,
                                           float* __restrict__ part_acc,
                                           float* __restrict__ part_ml,
                                           unsigned char* smem) {
  constexpr bool QUANT = POOL != BF16;
  constexpr int R = tile_rows<POOL>();
  constexpr int MK = MAXHD / 16;  // k16 steps of S^T, m16 tiles of O^T
  const int hd = a.hd, G = a.H / a.KvH;
  const int nk = hd / 16;
  const int NW = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which matrix, row
  const int pitch = code_pitch<POOL>(hd);
  const int sbytes = stage_bytes<POOL>(hd);
  const int rb = POOL == BF16 ? 2 * hd : hd;  // code bytes a row
  unsigned char* mine = smem + (size_t)warp * STAGES * sbytes;

  // this lane's 16-byte pieces of a tile's code rows: piece lane + 32 i is
  // (row r, chunk c), advanced by 32 pieces an iteration
  const int ch = rb / 16, npieces = R * ch;
  const int adv_r = 32 / ch, adv_c = 32 % ch;
  const int r_0 = lane / ch, c_0 = lane % ch;
  const char* kpool = (const char*)a.kpool;
  const char* vpool = (const char*)a.vpool;

  auto stage = [&](int t, int st) {
    unsigned char* kt = mine + (size_t)st * sbytes;
    unsigned char* vt = kt + R * pitch;
    const int k0 = T0 + t * TILE;
    // lane l: position k0 + l, clamped into [lo, hi] for its address
    const int pos = k0 + lane;
    const int pc = min(max(pos, lo), hi);
    const int blk = pc / a.ps;
    const int page = a.tables[(int64_t)b * a.NBLK + blk];
    const long long row =
        (((long long)a.layer * a.P + page) * a.KvH + kvh) * a.ps +
        (pc - blk * a.ps);
    if (QUANT) {
      float* kss = (float*)(vt + R * pitch);
      const int n = pos >= lo && pos <= hi ? 4 : 0;
      cp_async4_zfill(kss + lane, a.kscale + row, n);
      cp_async4_zfill(kss + TILE + lane, a.vscale + row, n);
    }
    int r = r_0, c = c_0;
    for (int i = 0; i * 32 < npieces; ++i) {
      // the row's position index, from the lane that holds it (packed int4
      // row r: positions 2r and 2r + 1, either live)
      const long long rr =
          __shfl_sync(FULL, row, (POOL == INT4 ? 2 * r : r) & 31);
      if (lane + 32 * i < npieces) {
        const int p0 = k0 + (POOL == INT4 ? 2 * r : r);
        const bool ok = POOL == INT4 ? p0 <= hi && p0 + 1 >= lo
                                     : p0 >= lo && p0 <= hi;
        const long long off =
            (POOL == INT4 ? rr >> 1 : rr) * rb + 16 * c;
        cp_async16_zfill(kt + r * pitch + 16 * c, kpool + off, ok ? 16 : 0);
        cp_async16_zfill(vt + r * pitch + 16 * c, vpool + off, ok ? 16 : 0);
      }
      r += adv_r;
      c += adv_c;
      if (c >= ch) {
        c -= ch;
        ++r;
      }
    }
  };

  // Q^T as B fragments of every k16 step (query row g; rows >= G zero),
  // with the code pools' permuted dims
  uint32_t qf[MK][2];
  {
    const __nv_bfloat16* qrow =
        a.q + ((int64_t)b * a.H + kvh * G + min(g, G - 1)) * hd;
    static_for<MK>([&](auto ST) {
      constexpr int st = decltype(ST)::value;
      qf[st][0] = qf[st][1] = 0u;
      if (st < nk && g < G) {
        if (QUANT) {
          const uint2 w = *(const uint2*)(qrow + 16 * st + 4 * t4);
          qf[st][0] = __byte_perm(w.x, w.y, 0x5410);
          qf[st][1] = __byte_perm(w.x, w.y, 0x7632);
        } else {
          qf[st][0] = *(const uint32_t*)(qrow + 16 * st + 2 * t4);
          qf[st][1] = *(const uint32_t*)(qrow + 16 * st + 2 * t4 + 8);
        }
      }
    });
  }

  float o[MK][4];
#pragma unroll
  for (int i = 0; i < MK; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m2[2] = {NEG_INF, NEG_INF};  // query columns 2t4, 2t4 + 1
  float l2[2] = {0.f, 0.f};          // this lane's share of l
  // the softcap's division, hoisted: a division in the tile loop is a
  // call (its slow path) that costs registers across it
  const float scale = a.scale, cap = a.softcap;
  const float inv_cap = cap > 0.f ? 1.f / cap : 0.f;

  int t = warp;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t + i * NW < ntiles) stage(t + i * NW, i);
    cp_async_commit();
  }
  for (int it = 0; t < ntiles; ++it, t += NW) {
    const int tn = t + (STAGES - 1) * NW;
    if (tn < ntiles) stage(tn, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this tile's copies have landed
    __syncwarp();
    const unsigned char* kt = mine + (size_t)(it % STAGES) * sbytes;
    const unsigned char* vt = kt + R * pitch;
    const float* kss = (const float*)(vt + R * pitch);
    const float* vss = kss + TILE;
    const int k0 = T0 + t * TILE;

    // S^T = K . Q^T for the tile's two 16-key blocks
    float s[2][4];
    static_for<2>([&](auto KB) {
      constexpr int kb = decltype(KB)::value;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[kb][e] = 0.f;
      static_for<MK>([&](auto ST) {
        constexpr int st = decltype(ST)::value;
        if (st < nk) {
          uint32_t af[4];
          if (POOL == BF16) {
            ldmatrix_x4(af, kt + (16 * kb + mr + 8 * (mi & 1)) * pitch +
                                2 * (16 * st + 8 * (mi >> 1)));
          } else if (POOL == INT8) {
            const unsigned char* k = kt + 16 * st + 4 * t4;
            const uint32_t ue =
                *(const uint32_t*)(k + (16 * kb + g) * pitch) ^ 0x80808080u;
            const uint32_t uo =
                *(const uint32_t*)(k + (16 * kb + g + 8) * pitch) ^
                0x80808080u;
            af[0] = i8_pair(ue, 0, ue, 2);
            af[1] = i8_pair(uo, 0, uo, 2);
            af[2] = i8_pair(ue, 1, ue, 3);
            af[3] = i8_pair(uo, 1, uo, 3);
          } else {
            const uint32_t w = *(const uint32_t*)(
                kt + (8 * kb + g) * pitch + 16 * st + 4 * t4);
            af[0] = i4_pair(w, 0);
            af[1] = i4_pair(w, 4);
            af[2] = i4_pair(w, 8);
            af[3] = i4_pair(w, 12);
          }
          mma_bf16(s[kb], af, qf[st][0], qf[st][1]);
        }
      });
    });

    // this lane's keys: rows g and g + 8 of each block; x scale, x key
    // scale, softcap, mask; the tile's max of each query column
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = 16 * kb + (POOL == INT4 ? 2 * g + h : g + 8 * h);
        const bool ok = k0 + key >= lo && k0 + key <= hi;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[kb][2 * h + e] * scale;
          if (QUANT) x = x * kss[key];
          if (cap > 0.f) x = cap * tanhf(x * inv_cap);
          x = ok ? x : NEG_INF;
          s[kb][2 * h + e] = x;
          mx[e] = fmaxf(mx[e], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = mx[e];
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 4));
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 8));
      v = fmaxf(v, __shfl_xor_sync(FULL, v, 16));
      const float m_new = fmaxf(m2[e], v);
      alpha[e] = __expf(m2[e] - m_new);
      m2[e] = m_new;
      l2[e] *= alpha[e];
    }

    // p = exp(s - m); l sums p, P^T's B fragments take bf16(p x vscale)
    uint32_t pb[2][2];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      float pv[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = 16 * kb + (POOL == INT4 ? 2 * g + h : g + 8 * h);
        const bool ok = k0 + key >= lo && k0 + key <= hi;
        const float vsc = QUANT ? vss[key] : 1.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ok ? __expf(s[kb][2 * h + e] - m2[e]) : 0.f;
          l2[e] += p;
          pv[2 * h + e] = p * vsc;
        }
      }
      pb[kb][0] = movmatrix_trans(pack_bf16(pv[0], pv[1]));
      pb[kb][1] = movmatrix_trans(pack_bf16(pv[2], pv[3]));
    }
    static_for<MK>([&](auto I) {
      constexpr int i = decltype(I)::value;
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[1];
      o[i][2] *= alpha[0];
      o[i][3] *= alpha[1];
    });

    // O^T += V^T . P^T
    static_for<2>([&](auto KB) {
      constexpr int kb = decltype(KB)::value;
      if (POOL == BF16) {
        static_for<MK>([&](auto I) {
          constexpr int i = decltype(I)::value;
          if (i < nk) {
            uint32_t af[4];
            ldmatrix_x4_trans(af, vt + (16 * kb + mr + 8 * (mi >> 1)) * pitch +
                                      2 * (16 * i + 8 * (mi & 1)));
            mma_bf16(o[i], af, pb[kb][0], pb[kb][1]);
          }
        });
      } else {
        // the code rows this lane reads (see v_frags)
        constexpr int NV = POOL == INT8 ? 4 : 2;
        const unsigned char* vr[NV];
#pragma unroll
        for (int k = 0; k < NV; ++k)
          vr[k] = vt + (POOL == INT8
                            ? 16 * kb + 2 * t4 + (k & 1) + 8 * (k >> 1)
                            : 8 * kb + 2 * t4 + k) * pitch;
        static_for<MK / 2>([&](auto J) {
          constexpr int j = decltype(J)::value;
          if (j < hd / 32) {
            uint32_t w[4] = {0u, 0u, 0u, 0u}, a0[4], a1[4];
#pragma unroll
            for (int k = 0; k < NV; ++k)
              w[k] = *(const uint32_t*)(vr[k] + 4 * (g + 8 * j));
            v_frags<POOL>(w, a0, a1);
            mma_bf16(o[2 * j], a0, pb[kb][0], pb[kb][1]);
            mma_bf16(o[2 * j + 1], a1, pb[kb][0], pb[kb][1]);
          } else if (j == hd / 32 && (hd & 16)) {
            // hd % 32 == 16: the last tile from half-words
            uint32_t w[4] = {0u, 0u, 0u, 0u}, a0[4], a1[4];
#pragma unroll
            for (int k = 0; k < NV; ++k)
              w[k] = *(const uint16_t*)(vr[k] + 32 * j + 2 * g);
            v_frags<POOL>(w, a0, a1);
            mma_bf16(o[2 * j], a0, pb[kb][0], pb[kb][1]);
          }
        });
      }
    });
    __syncwarp();  // this stage is read before it is staged again
  }
  cp_async_wait<0>();

  // merge the warps' states through shared memory (the rings are free):
  // M = max m_w, L = sum l_w e_w, A = sum acc_w e_w, e_w = exp(m_w - M)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l2[e] += __shfl_xor_sync(FULL, l2[e], 4);
    l2[e] += __shfl_xor_sync(FULL, l2[e], 8);
    l2[e] += __shfl_xor_sync(FULL, l2[e], 16);
  }
  __syncthreads();
  float* Mw = (float*)smem;   // [NW][8]
  float* Lw = Mw + NW * 8;    // [NW][8]
  float* Aw = Lw + NW * 8;    // [NW][8][hd]
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      Mw[warp * 8 + 2 * t4 + e] = m2[e];
      Lw[warp * 8 + 2 * t4 + e] = l2[e];
    }
  }
  static_for<MK>([&](auto I) {
    constexpr int i = decltype(I)::value;
    if (i < nk) {
      const int d0 = out_dim<POOL>(i, g, hd);
      const int d1 = d0 + (POOL == BF16 ? 8 : 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qr = 2 * t4 + e;
        if (qr < G) {
          float* A = Aw + ((size_t)warp * 8 + qr) * hd;
          A[d0] = o[i][e];
          A[d1] = o[i][2 + e];
        }
      }
    }
  });
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int gg = idx / hd, d = idx - gg * hd;
    float M = NEG_INF;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * 8 + gg]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float e = __expf(Mw[w * 8 + gg] - M);
      L = fmaf(Lw[w * 8 + gg], e, L);
      A = fmaf(Aw[((size_t)w * 8 + gg) * hd + d], e, A);
    }
    part_acc[(run_e + gg) * hd + d] = A;
    if (d == 0) {
      part_ml[(run_e + gg) * 2] = M;
      part_ml[(run_e + gg) * 2 + 1] = L;
    }
  }
}

// One CTA of nw warps per (kv head, slot, chunk); hd a multiple of 16 up to
// MAXHD. Stores the chunk's partial as run blockIdx.y * gridDim.z +
// blockIdx.z of part_acc [runs, KvH, G, hd] and part_ml [runs, KvH, G, 2].
template <int MAXHD, int POOL>
__global__ void __launch_bounds__(128)
paged_mma_kernel(Params a, int cp, float* __restrict__ part_acc,
                 float* __restrict__ part_ml) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.H / a.KvH;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int64_t run_e =
      (((int64_t)b * gridDim.z + blockIdx.z) * a.KvH + kvh) * G;

  int lo, hi;
  if (!chunk_rows(a, a.lengths[b], cp, blockIdx.z, lo, hi)) {
    if (threadIdx.x < G) {  // no live row in this chunk: a partial of 0
      part_ml[(run_e + threadIdx.x) * 2] = NEG_INF;
      part_ml[(run_e + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }
  const int T0 = lo & ~(TILE - 1);
  fold_tiles<MAXHD, POOL>(a, b, kvh, lo, hi, T0, (hi - T0) / TILE + 1,
                          run_e, part_acc, part_ml, smem);
}

// hd not a multiple of 16: one CTA of NTHREADS per (kv head, slot, chunk)
// folds the chunk's live blocks with the scalar page loop into the same
// partials. (At least 4 CTAs a SM: without that bound ptxas gives it 72-80
// registers and spills one across the page loop's division calls.)
template <typename T, bool QUANT, bool PACK4>
__global__ void __launch_bounds__(NTHREADS, 4)
paged_scalar_kernel(Params a, int cp, float* __restrict__ part_acc,
                    float* __restrict__ part_ml) {
  extern __shared__ float fsmem[];
  const int G = a.H / a.KvH;
  const Smem sm(fsmem, G, a.hd, a.ps, sizeof(T));
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int qp = a.lengths[b];
  int lo, hi;
  if (!chunk_rows(a, qp, cp, blockIdx.z, lo, hi)) {
    if (threadIdx.x < G) {
      const int64_t e =
          (((int64_t)b * gridDim.z + blockIdx.z) * a.KvH + kvh) * G +
          threadIdx.x;
      part_ml[e * 2] = NEG_INF;
      part_ml[e * 2 + 1] = 0.f;
    }
    return;
  }
  const int first = lo / a.ps, last = hi / a.ps;
  load_q(a, sm, G, b, kvh);
  State st;
  init_state(st);
  for (int i = first; i <= last; ++i)
    page_update<T, QUANT, PACK4>(a, sm, st, G, b, kvh, i, qp);
  store_partial(a, st, G, b * gridDim.z + blockIdx.z, kvh, part_acc,
                part_ml);
}

template <int MAXHD, int POOL>
int launch_mma(const Params& a, int cp, int nchunk, float* part_acc,
               float* part_ml, cudaStream_t stream) {
  static size_t granted = 48 << 10;
  const int nw = mma_warps<POOL>(a.hd);
  const size_t smem = mma_smem_bytes<POOL>(a.hd, nw);
  allow_smem(paged_mma_kernel<MAXHD, POOL>, smem, granted);
  paged_mma_kernel<MAXHD, POOL><<<dim3(a.KvH, a.B, nchunk), 32 * nw, smem,
                                  stream>>>(a, cp, part_acc, part_ml);
  return (int)cudaGetLastError();
}

// The split call: partials of every (kv head, slot, chunk of cp blocks of
// [0, a.nblk)), then merge_chunks. Returns cudaGetLastError().
template <typename T, bool QUANT, bool PACK4>
int launch_split(const Params& a, int cp, float* part_acc, float* part_ml,
                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int nchunk = (a.nblk + cp - 1) / cp;
  constexpr int POOL = !QUANT ? BF16 : PACK4 ? INT4 : INT8;
  int rc;
  if (paged_tensor_cores(a.hd)) {
    rc = a.hd <= 128
             ? launch_mma<128, POOL>(a, cp, nchunk, part_acc, part_ml, s)
             : launch_mma<256, POOL>(a, cp, nchunk, part_acc, part_ml, s);
  } else {
    static size_t granted = 48 << 10;
    const size_t smem =
        sizeof(float) * smem_floats(a.H / a.KvH, a.hd, a.ps, sizeof(T));
    allow_smem(paged_scalar_kernel<T, QUANT, PACK4>, smem, granted);
    paged_scalar_kernel<T, QUANT, PACK4>
        <<<dim3(a.KvH, a.B, nchunk), NTHREADS, smem, s>>>(a, cp, part_acc,
                                                          part_ml);
    rc = (int)cudaGetLastError();
  }
  if (rc) return rc;
  return split::launch_merge(part_acc, part_ml, a.out, a.B, a.H, a.KvH, a.hd,
                             nchunk, s);
}

}  // namespace
