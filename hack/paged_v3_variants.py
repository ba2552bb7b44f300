#!/usr/bin/env python3
"""Time design variants of the torch port's paged v3 decode kernel
(``ollama_operator_tpu_torch/csrc/paged_decode.cu``, K6, whose tile loop
and split launch are ``csrc/paged_tiles.cuh``) on one H100.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 hack/paged_v3_variants.py [--out DIR] [--variants a,b,...]
                                      [--chunks 256,128,512]

Each variant is the committed source with a few lines replaced (the
replacements are below), built into its own copy of the package under
``_variants/`` (gitignored) and imported under its own name, so every
variant runs in the same process on the same card. Variants:

- ``base``: the source as committed (a 2-stage ring of 32-position tiles
  a warp, 4 warps a CTA, K as the 16-row A operand);
- ``stages3``: a 3-stage ring;
- ``warps8``: 8 warps a CTA, each with a 1-stage ring (every tile of a
  256-position chunk in flight at once);
- ``strided1``, ``strided4``: at most 1 or 4 CTAs a (kv head, slot),
  CTA s walking chunks s, s + S, ... in place of one CTA a chunk;
- ``q_rows`` (int8 pool only; the other pools run the committed code):
  the group's query rows as the 16-row A operand and the keys as n8
  columns (the dense-cache kernel's layout): S = Q . K^T, O += P . V, 15/16
  of each tile's rows idle at G = 1 where ``base`` idles 7/8 of its
  columns.

Every variant is checked against ``paged_decode_attention_plain(route=
"v3")`` (each slot within 1% of its largest output) and timed with
``chip_smoke.Timer`` (L2 flushed before every launch), at the K6 rows of
``chip_smoke.py`` and at the serving step as the engine calls it (every
slot, 8 active), at each chunk of ``--chunks`` positions, two rounds in
turns. Prints one line a shape and chunk, and writes
``DIR/paged_v3_variants.json``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import shutil
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARPS8 = [
    ("constexpr int STAGES = 2;", "constexpr int STAGES = 1;"),
    ("__launch_bounds__(128)\npaged_mma_kernel",
     "__launch_bounds__(256)\npaged_mma_kernel"),
    ("return mma_smem_bytes<POOL>(hd, 4) <= MAX_SMEM ? 4 : 2;",
     "return mma_smem_bytes<POOL>(hd, 8) <= MAX_SMEM ? 8 "
     ": mma_smem_bytes<POOL>(hd, 4) <= MAX_SMEM ? 4 : 2;"),
]

# q_rows: the int8 pool's tile with Q as the A operand (a0/a2 of query row
# g are Q^T's b0/b1 of the committed layout; rows 8..15 zero) and each
# 8-key group of the tile as an n8 column block; P's A fragments come
# straight from S's accumulators; V as the B operand, lane g's dims those
# of its V words g + 8w (dim 4(g + 8w) + e of column block 4w + e).
Q_ROWS_STATE = """  float l2[2] = {0.f, 0.f};          // this lane's share of l
  float m1 = NEG_INF, l1 = 0.f;      // q_rows: query row g
  float o2[2 * MK][4] = {};
"""
Q_ROWS_TILE = """    if constexpr (POOL == INT8) {
      float s4[4][4];
      static_for<4>([&](auto NT) {
        constexpr int nt = decltype(NT)::value;
#pragma unroll
        for (int e = 0; e < 4; ++e) s4[nt][e] = 0.f;
        static_for<MK>([&](auto ST) {
          constexpr int st = decltype(ST)::value;
          if (st < nk) {
            const uint32_t u = *(const uint32_t*)(
                kt + (8 * nt + g) * pitch + 16 * st + 4 * t4) ^ 0x80808080u;
            const uint32_t qa[4] = {qf[st][0], 0u, qf[st][1], 0u};
            mma_bf16(s4[nt], qa, i8_pair(u, 0, u, 2), i8_pair(u, 1, u, 3));
          }
        });
      });
      float mx = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * nt + 2 * t4 + e;
          const bool ok = k0 + key >= lo && k0 + key <= hi;
          float x = s4[nt][e] * scale * kss[key];
          if (cap > 0.f) x = cap * tanhf(x * inv_cap);
          x = ok ? x : NEG_INF;
          s4[nt][e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m1, mx);
      const float alpha = __expf(m1 - m_new);
      m1 = m_new;
      l1 *= alpha;
      uint32_t pa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 16 * j + 8 * h + 2 * t4 + e;
            const bool ok = k0 + key >= lo && k0 + key <= hi;
            const float p = ok ? __expf(s4[2 * j + h][e] - m1) : 0.f;
            l1 += p;
            pv[e] = p * vss[key];
          }
          pa[j][2 * h] = pack_bf16(pv[0], pv[1]);
          pa[j][2 * h + 1] = 0u;
        }
      }
      static_for<2 * MK>([&](auto D) {
        constexpr int dn = decltype(D)::value;
        o2[dn][0] *= alpha;
        o2[dn][1] *= alpha;
      });
      static_for<2>([&](auto J) {
        constexpr int j = decltype(J)::value;
        const unsigned char* v0 = vt + (16 * j + 2 * t4) * pitch;
        static_for<MK / 2>([&](auto W) {
          constexpr int w = decltype(W)::value;
          if (w < hd / 32) {
            const int off = 4 * (g + 8 * w);
            const uint32_t r0 = *(const uint32_t*)(v0 + off) ^ 0x80808080u;
            const uint32_t r1 =
                *(const uint32_t*)(v0 + pitch + off) ^ 0x80808080u;
            const uint32_t r2 =
                *(const uint32_t*)(v0 + 8 * pitch + off) ^ 0x80808080u;
            const uint32_t r3 =
                *(const uint32_t*)(v0 + 9 * pitch + off) ^ 0x80808080u;
            static_for<4>([&](auto E) {
              constexpr int e = decltype(E)::value;
              mma_bf16(o2[4 * w + e], pa[j], i8_pair(r0, e, r1, e),
                       i8_pair(r2, e, r3, e));
            });
          }
        });
      });
    } else {
"""
Q_ROWS_TILE_END = """    }
    __syncwarp();  // this stage is read before it is staged again"""
Q_ROWS_EPILOGUE = """  if constexpr (POOL == INT8) {
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    if (t4 == 0) {
      Mw[warp * 8 + g] = m1;
      Lw[warp * 8 + g] = l1;
    }
    static_for<2 * MK>([&](auto D) {
      constexpr int dn = decltype(D)::value;
      if (dn < hd / 8 && g < G) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 2 * t4 + e;
          Aw[((size_t)warp * 8 + g) * hd + 4 * (n + 8 * (dn / 4)) + dn % 4] =
              o2[dn][e];
        }
      }
    });
  } else {
  if (g == 0) {"""

Q_ROWS = [
    ("  float l2[2] = {0.f, 0.f};          // this lane's share of l\n",
     Q_ROWS_STATE),
    ("    // S^T = K . Q^T for the tile's two 16-key blocks\n",
     Q_ROWS_TILE + "    // S^T = K . Q^T for the tile's two 16-key blocks\n"),
    ("    __syncwarp();  // this stage is read before it is staged again",
     Q_ROWS_TILE_END),
    ("  float* Aw = Lw + NW * 8;    // [NW][8][hd]\n  if (g == 0) {",
     "  float* Aw = Lw + NW * 8;    // [NW][8][hd]\n" + Q_ROWS_EPILOGUE),
    ("""          A[d1] = o[i][2 + e];
        }
      }
    }
  });
""", """          A[d1] = o[i][2 + e];
        }
      }
    }
  });
  }
"""),
]

# strided<S>: S CTAs a (kv head, slot), CTA s walking chunks s, s + S, ...
# (each chunk's partial as before), in place of one CTA a chunk
def strided(S):
    return [
        ("""  const int kvh = blockIdx.x, b = blockIdx.y;
  const int64_t run_e =
      (((int64_t)b * gridDim.z + blockIdx.z) * a.KvH + kvh) * G;

  int lo, hi;
  if (!chunk_rows(a, a.lengths[b], cp, blockIdx.z, lo, hi)) {""",
         """  const int kvh = blockIdx.x, b = blockIdx.y;
  const int nchunk = (a.nblk + cp - 1) / cp;
  for (int z = blockIdx.z; z < nchunk; z += gridDim.z) {
  const int64_t run_e = (((int64_t)b * nchunk + z) * a.KvH + kvh) * G;

  int lo, hi;
  if (!chunk_rows(a, a.lengths[b], cp, z, lo, hi)) {"""),
        ("""      part_ml[(run_e + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }
  const int T0 = lo & ~(TILE - 1);""",
         """      part_ml[(run_e + threadIdx.x) * 2 + 1] = 0.f;
    }
    continue;
  }
  const int T0 = lo & ~(TILE - 1);"""),
        ("""  fold_tiles<MAXHD, POOL>(a, b, kvh, lo, hi, T0, (hi - T0) / TILE + 1,
                          run_e, part_acc, part_ml, smem);
}
""", """  fold_tiles<MAXHD, POOL>(a, b, kvh, lo, hi, T0, (hi - T0) / TILE + 1,
                          run_e, part_acc, part_ml, smem);
  __syncthreads();
  }
}
"""),
        ("paged_mma_kernel<MAXHD, POOL><<<dim3(a.KvH, a.B, nchunk)",
         f"paged_mma_kernel<MAXHD, POOL><<<dim3(a.KvH, a.B, "
         f"nchunk < {S} ? nchunk : {S})"),
    ]


VARIANTS = {
    "base": [],
    "strided1": strided(1),
    "strided4": strided(4),
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    "warps8": WARPS8,
    "q_rows": Q_ROWS,
}

# (label, B, ps, NBLK, H, KvH, hd, bits, max_len, window, serving, idle)
SHAPES = [
    ("int8 H=32 main", 64, 128, 32, 32, 8, 128, 8, 2048, 0, False),
    ("int8 H=24", 64, 128, 32, 24, 8, 128, 8, 2048, 0, False),
    ("int4 H=24", 64, 128, 32, 24, 8, 128, 4, 2048, 0, False),
    ("bf16 H=32", 64, 128, 32, 32, 8, 128, 16, 2048, 0, False),
    ("phi3 G=1", 32, 64, 64, 32, 32, 96, 8, 4095, 2047, False),
    ("int8 H=32 serving", 8, 128, 32, 32, 8, 128, 8, 300, 0, True),
    ("phi3 G=1 serving", 8, 64, 64, 32, 32, 96, 8, 300, 2047, True),
    # the serving step as the engine calls it: all slots, 8 of them active
    ("int8 H=32 engine step", 64, 128, 32, 32, 8, 128, 8, 300, 0, True,
     56),
    ("phi3 G=1 engine step", 32, 64, 64, 32, 32, 96, 8, 300, 2047, True,
     24),
]


def make_variant(name, reps):
    """A copy of the package with the variant's paged_tiles.cuh (the v3
    kernel's tile loop and split launch, which the v2 and v4 kernels
    share), imported as ``var_<name>``; returns its ops.paged and
    ops.cuda_build."""
    root = os.path.join(ROOT, "_variants", name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "ollama_operator_tpu_torch"),
                    os.path.join(root, "ollama_operator_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = os.path.join(root, "ollama_operator_tpu_torch", "csrc",
                       "paged_tiles.cuh")
    text = open(src).read()
    for old, new in reps:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: anchor not found once: "
                               f"{old[:60]!r}")
        text = text.replace(old, new)
    open(src, "w").write(text)
    pkg = os.path.join(root, "ollama_operator_tpu_torch")
    mod_name = f"var_{name}"
    spec = importlib.util.spec_from_file_location(
        mod_name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{mod_name}.ops.paged"),
            importlib.import_module(f"{mod_name}.ops.cuda_build"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--chunks", default="256,128,512",
                    help="PAGED_CHUNK values to time each variant at")
    args = ap.parse_args()
    import torch

    import chip_smoke as CS
    from ollama_operator_tpu_torch.ops import paged as PG
    if not torch.cuda.is_available():
        print("paged_v3_variants: CUDA is not available", file=sys.stderr)
        return 1
    card = CS.smi_line()
    print(f"card: {card}", flush=True)
    names = args.variants.split(",")
    mods = {n: make_variant(n, VARIANTS[n]) for n in names}
    errors = []

    def build(cb):
        try:
            cb.build(["paged_decode"])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
    threads = [threading.Thread(target=build, args=(cb,))
               for _, cb in mods.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    out = {"card": card, "ptxas": {}, "rows": []}
    for n, (_, cb) in mods.items():
        rep = cb.ptxas_report("paged_decode")
        out["ptxas"][n] = dict(
            registers=[int(x) for x in re.findall(r"Used (\d+) registers",
                                                  rep)],
            spill_bytes=sum(int(x) for x in re.findall(
                r"(\d+) bytes spill stores", rep)))
        print(f"{n}: {out['ptxas'][n]}", flush=True)
    timer = CS.Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(CS.SEED)
    bad = []
    for label, B, ps, NBLK, H, KvH, hd, bits, max_len, window, *rest in (
            SHAPES):
        a = CS.paged_inputs(torch, g, B, ps, NBLK, H, KvH, hd, bits,
                            max_len, window, *rest)
        ref = PG.paged_decode_attention_plain(*a, nblk=1, route="v3")
        tol = 1e-2 * ref.float().reshape(B, -1).abs().amax(1)
        for chunk in (int(c) for c in args.chunks.split(",")):
            ms = {n: [] for n in mods}
            for rnd in range(2):
                for n in (names if rnd == 0 else names[::-1]):
                    pg = mods[n][0]
                    pg.PAGED_CHUNK = chunk
                    got = pg.paged_decode_attention_v3(*a, nblk=1)
                    err = (got.float() - ref.float()).reshape(B, -1)
                    if not bool((err.abs().amax(1) <= tol).all()):
                        bad.append(f"{n} {label} chunk {chunk}")
                    ms[n].append(timer(
                        lambda: pg.paged_decode_attention_v3(*a, nblk=1),
                        iters=20))
            out["rows"].append(dict(shape=label, chunk=chunk, ms=ms))
            print(f"{label} chunk {chunk}: "
                  + " ".join(f"{n} {v[0]:.4f}/{v[1]:.4f}"
                             for n, v in ms.items()), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "paged_v3_variants.json"), "w") as f:
            json.dump(out, f, indent=1)
    if bad:
        print(f"disagree with the plain version: {bad}", file=sys.stderr)
        return 1
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
