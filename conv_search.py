#!/usr/bin/env python3
"""Design search of the fused conv kernel (``mxtpu_torch/csrc/fused_conv.cu``)
on one NVIDIA card, at the 5 convs one ResNet-50 v1 forward at batch 8
sends to it:

    python3 conv_search.py [tiles] [variants]

* ``tiles``: every output tile the C entry point has (bf16 64 or 128
  pixels by 64 or 128 channels; f32 128 x 64 and 64 x 128), each checked
  against the plain version and timed by CUDA-graph replay beside
  ``F.conv2d``; ``*`` marks the tile ``_launch_args`` picks.
* ``variants``: the kernel source with one thing changed, built at
  runtime through ``mxtpu_torch.kernels.runtime_library`` and timed by
  graph replay at the launch ``_launch_args`` picks: 2-stage rings, each
  block's K order rotated, and ablations that cut one part out (bf16:
  A's loads, the MMAs; f32: B's shared-memory reads, its FMAs becoming
  adds; both: the output stores). An ablation computes
  a wrong result on purpose, so no variant is checked; "base" (the source
  as it is) runs first and last, for the spread.

Both modes without arguments. The measuring helpers come from
``chip_smoke.py``. Prints one line per timing; send it to a file.
"""
import concurrent.futures
import ctypes
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def sub(src, old, new):
    if old not in src:
        raise AssertionError("conv_search: the source no longer has %r" % old)
    return src.replace(old, new)


def source_variants(src):
    """{name: source text}: "base" first and last."""
    tc_load = ("        cp_async16(dst + Tile<64>::off(r, 8 * j, BM), "
               "o >= 0 ? x + o : x, o >= 0 ? 16 : 0);")
    mma = ("      wgmma_tn(acc, gmma_desc(sa + kk * 32, 16, 1024, 1),\n"
           "               gmma_desc(sb + kk * 16 * ROWB, BK * ROWB, 1024, "
           "1), t > 0 || kk > 0);")
    fma = ("          for (int j = 0; j < 8; ++j) acc[i][j] = "
           "fmaf(ar, br[j], acc[i][j]);")
    tc_store = ("      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16("
                "v[0], v[1]), pack_bf16(v[2], v[3]),")
    f32_store = ("        *reinterpret_cast<float4*>(out + o) = "
                 "make_float4(v[0], v[1], v[2], v[3]);")
    rotate = [
        ("    stage_a(slot, t * BK);\n    stage_b(slot + A_BYTES, t * BK);",
         "    const int c = (t + (int)(blockIdx.x % a.chunks)) % a.chunks;\n"
         "    stage_a(slot, c * BK);\n    stage_b(slot + A_BYTES, c * BK);"),
        ("    if (s < a.chunks) stage(s, s * BK);",
         "    if (s < a.chunks) stage(s, ((s + (int)(blockIdx.x % "
         "a.chunks)) % a.chunks) * BK);"),
        ("      stage((t + F32_STAGES - 1) % F32_STAGES, "
         "(t + F32_STAGES - 1) * BK);",
         "      stage((t + F32_STAGES - 1) % F32_STAGES, ((t + F32_STAGES"
         " - 1 + (int)(blockIdx.x % a.chunks)) % a.chunks) * BK);")]
    rotated = src
    for old, new in rotate:
        rotated = sub(rotated, old, new)
    out = {"base": src,
           "rings of 2": sub(sub(src, "constexpr int TC_STAGES = 4;",
                                 "constexpr int TC_STAGES = 2;"),
                             "constexpr int F32_STAGES = 3;",
                             "constexpr int F32_STAGES = 2;"),
           "K order rotated": rotated,
           "no A loads (bf16)": sub(src, tc_load, ""),
           "no MMA (bf16)": sub(src, mma, ""),
           "B reads cut (f32)": sub(src, fma, "          for (int j = 0; "
                                    "j < 8; ++j) acc[i][j] += ar;"),
           "no output stores": sub(sub(src, tc_store, "      if (0) "
                                       + tc_store.lstrip()), f32_store,
                                   "        if (0) " + f32_store.lstrip())}
    out["base, again"] = src + "\n// again\n"
    return out


def main(argv):
    modes = set(argv) or {"tiles", "variants"}
    import torch
    if not torch.cuda.is_available():
        print("conv_search: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch.nn.functional as F
    import chip_smoke as cs
    from mxtpu_torch import kernels
    from mxtpu_torch.ops.pallas import conv as pc
    print("card: " + cs.card_line(), flush=True)
    kernels.build_all(["fused_conv"])
    rule, entry = pc._launch_args, pc._entry
    fns = {}
    if "variants" in modes:
        t0 = time.time()
        src = open(os.path.join(kernels.CSRC, "fused_conv.cu")).read()

        def build(item):
            lib, _, _ = kernels.runtime_library(
                item[1], ("-I", str(kernels.CSRC)))
            fn = lib.mxtpu_fused_conv_fwd
            fn.restype, fn.argtypes = ctypes.c_int, entry().argtypes
            return item[0], fn
        variants = source_variants(src)
        with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
            fns = dict(ex.map(build, variants.items()))
        print("built %d variants in %.1f s" % (len(fns), time.time() - t0),
              flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    try:
        for dtype in ("bfloat16", "float32"):
            dt = getattr(torch, dtype)
            for name, n, hw, cin, cout, k, s, p, _ in cs.RESNET50_GATED:
                x = torch.randn(n, hw, hw, cin, device="cuda",
                                generator=gen).to(dt)
                w = (torch.randn(k, k, cin, cout, device="cuda",
                                 generator=gen)
                     * math.sqrt(2.0 / (k * k * cin))).to(dt)
                pad = ((p, p), (p, p))
                conv = lambda: pc.fused_conv(x, w, (s, s), pad)
                xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
                lib = cs.graph_ms(lambda: F.conv2d(xn, wn, stride=s,
                                                   padding=p))
                base = rule(x, w, (s, s), pad)
                if "tiles" in modes:
                    ref = pc.fused_conv_reference(x.float(), w.float(),
                                                  (s, s), pad)[0]
                    m = ref.numel() // cout
                    tiles = [(bm, bn) for bm in (64, 128) for bn in (64, 128)
                             if base.route or bm * bn == 128 * 64]
                    for bm, bn in tiles:
                        la = base._replace(
                            block_m=bm, block_n=bn,
                            threads=bm // 64 * 128 if base.route else 128,
                            grid=(-(-m // bm), -(-cout // bn)))
                        pc._launch_args = lambda *a, la=la, **kw: la
                        cs.check(conv(), ref, dtype, name)
                        print("tile %s %-8s %-22s %3d x %-3d graph %.4f ms  "
                              "F.conv2d %.4f ms" % (
                                  "*" if la == base else " ", dtype, name, bm,
                                  bn, cs.graph_ms(conv), lib), flush=True)
                    pc._launch_args = rule
                for vname, fn in fns.items():
                    pc._entry = lambda fn=fn: fn
                    print("variant %-8s %-22s %-18s graph %.4f ms  F.conv2d "
                          "%.4f ms" % (dtype, name, vname, cs.graph_ms(conv),
                                       lib), flush=True)
                pc._entry = entry
    finally:
        pc._launch_args, pc._entry = rule, entry
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
