#!/usr/bin/env python3
"""Design search for two kernels of the port, on one NVIDIA card:

    python3 variant_search.py [flash] [rtc]

* ``flash``: text edits of ``mxtpu_torch/csrc/flash_attention.cu``'s sliced
  kernels (head dims past 128) built through ``kernels.runtime_library``
  (with ``-I csrc``) and swapped in for the flash wrapper's C entry point:
  the bfloat16 chunk of D per S item (64 or 128 columns) and the ring's
  depth (2, 3 or 4 slots). Each is held against the plain version and
  timed by CUDA-graph replay (``chip_smoke.graph_ms``) at b8 h12 T512 with
  D 160, 256 and 320, causal and not, beside
  ``F.scaled_dot_product_attention``.
* ``rtc``: the runtime examples of ``chip_smoke.RTC_SOURCE`` (kernel B3)
  with UNROLL 1, 2, 4 or 8 vectors a thread, a thread's vectors a grid or
  a block apart, and blocks of 128, 256 or 512 threads over a grid that
  covers the array in one pass; and at the chosen UNROLL and block, the
  ``__ldcs``/``__stcs`` hints, and a grid of 2048 threads per SM that
  walks the array. Each is held against its plain version and timed
  eagerly (``chip_smoke.cuda_ms``) at n = 25,557,032 beside its one-call
  PyTorch equivalent, two rounds.

An edit whose text is gone from the source raises. Prints one line per
variant and shape; writes nothing.
"""
import ctypes
import concurrent.futures
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def sub(src, old, new):
    if old not in src:
        raise AssertionError("variant_search: %r is gone from the source"
                             % old[:60])
    return src.replace(old, new)


def flash_variants(src):
    """{name: source}: the base (a 2-slot ring of 64-column chunks) and
    each other ring depth and chunk width of the bf16 sliced kernel."""
    dc128 = [("constexpr int WIDE_BF16_DC = 64;",
              "constexpr int WIDE_BF16_DC = 128;"),
             ("constexpr uint32_t WIDE_BF16_SLOT = 16384;",
              "constexpr uint32_t WIDE_BF16_SLOT = 32768;")]
    out = {"base": src}
    for stages in (2, 3, 4):
        for chunk in (64, 128):
            if (stages, chunk) == (2, 64):
                continue
            v = sub(src, "constexpr int WIDE_BF16_STAGES = 2;",
                    "constexpr int WIDE_BF16_STAGES = %d;" % stages)
            if chunk == 128:
                for old, new in dc128:
                    v = sub(v, old, new)
            out["ring %d, chunk %d" % (stages, chunk)] = v
    return out


def flash_search(cs):
    import torch
    import torch.nn.functional as F
    from mxtpu_torch import kernels
    from mxtpu_torch.ops.pallas import flash_attention as fa
    kernels.build_all(["flash_attention"])
    entry = fa._entry
    src = open(os.path.join(kernels.CSRC, "flash_attention.cu")).read()

    def build(item):
        lib, _, _ = kernels.runtime_library(item[1],
                                            ("-I", str(kernels.CSRC)))
        fn = lib.mxtpu_flash_attention_fwd
        fn.restype, fn.argtypes = ctypes.c_int, entry().argtypes
        return item[0], fn
    variants = flash_variants(src)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as ex:
        fns = dict(ex.map(build, variants.items()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    try:
        for dtype in ("bfloat16", "float32"):
            for d in (160, 256, 320):
                for causal in (False, True):
                    q, k, v = cs.flash_inputs(8, 12, 512, 512, d,
                                              getattr(torch, dtype),
                                              "contig", gen)
                    ref = fa.flash_attention_reference(
                        q.float(), k.float(), v.float(), causal)[0]
                    sdpa = cs.graph_ms(lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal))
                    for name, fn in fns.items():
                        if dtype == "float32" and name != "base":
                            continue   # the edits touch the bf16 kernel only
                        fa._entry = lambda fn=fn: fn
                        kern = lambda: fa.flash_attention(q, k, v, causal)
                        err = cs.check(kern(), ref, dtype, name)
                        print("flash %-8s b8 h12 T512 d%d%-7s %-16s graph "
                              "%.4f ms  sdpa %.4f ms  err %.3g" % (
                                  dtype, d, " causal" * causal, name,
                                  cs.graph_ms(kern), sdpa, err), flush=True)
    finally:
        fa._entry = entry


# the vector layout of RTC_SOURCE's stream_vectors: a thread's UNROLL
# vectors a grid apart (as written), or a block apart, so that each block
# moves one contiguous run of UNROLL * block vectors
BLOCK_RUNS = [
    ("  const long long step = (long long)gridDim.x * blockDim.x;",
     "  const long long step = blockDim.x;"),
    ("  const long long first = (long long)blockIdx.x * blockDim.x + "
     "threadIdx.x;",
     "  const long long first = (long long)blockIdx.x * blockDim.x * UNROLL"
     " + threadIdx.x;")]


def rtc_search(cs):
    import torch
    from mxtpu_torch import rtc
    n = 25557032
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    xs = {name: cs.rtc_inputs(name, n, gen) for name, *_ in cs.RTC_KERNELS}
    unroll_line = "#define UNROLL %d" % cs.RTC_UNROLL
    base = (cs.RTC_UNROLL, "grid apart", "plain", cs.RTC_BLOCK, "one pass")
    configs = [(u, layout, "plain", b, "one pass") for u in (1, 2, 4, 8)
               for layout in ("grid apart", "block runs")
               for b in (128, 256, 512)
               if u * b <= 2048]   # 8 x 512 asks too many registers
    configs += [base[:2] + ("ldcs/stcs",) + base[3:],
                base[:4] + ("2048 threads per SM",)]

    def source(unroll, layout, hints):
        src = sub(cs.RTC_STREAMING if hints == "ldcs/stcs"
                  else cs.RTC_SOURCE, unroll_line, "#define UNROLL %d"
                  % unroll)
        if layout == "block runs":
            for old, new in BLOCK_RUNS:
                src = sub(src, old, new)
        return src
    for rnd in range(2):
        print("rtc round %d torch: %s" % (rnd, ", ".join(
            "%s %.4f ms" % (name, cs.cuda_ms(lambda: lib(*xs[name])))
            for name, _, _, _, lib in cs.RTC_KERNELS if lib)), flush=True)
        for unroll, layout, hints, threads, rule in configs:
            mod = rtc.CudaModule(source(unroll, layout, hints)).build()
            res = []
            for name, _, dtype, check, _ in cs.RTC_KERNELS:
                k = mod.get_kernel(name)
                per = unroll * (4 if dtype == "float32" else 8)
                grid = -(-n // (threads * per))
                if rule != "one pass":
                    grid = min(grid, 2048 // threads * sms)
                run = lambda: k.launch(xs[name] + [n], (n,), grid=(grid,),
                                       block=(threads,))
                plain = cs.RTC_PLAIN[name]
                cs.rtc_check(run().to_torch(), plain(*xs[name]), check,
                             name, mag=plain(*[t.abs() for t in xs[name]]))
                res.append("%s %.4f" % (name, cs.cuda_ms(run)))
            print("rtc round %d unroll %d %-10s %-9s block %3d grid %-19s: "
                  "%s" % (rnd, unroll, layout, hints, threads, rule,
                          ", ".join(res)), flush=True)


def main(argv):
    modes = set(argv) or {"flash", "rtc"}
    import torch
    if not torch.cuda.is_available():
        print("variant_search: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    print("card: " + cs.card_line(), flush=True)
    if "flash" in modes:
        flash_search(cs)
    if "rtc" in modes:
        rtc_search(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
