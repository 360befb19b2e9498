#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``mxtpu_torch``): run
``python3 chip_smoke.py`` from the root of a checkout on a machine with one
NVIDIA H100.

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every kernel of ``mxtpu_torch/csrc/`` with nvcc for sm_90a.
3. Holds the hand-written fused conv kernel against its plain PyTorch
   version at the ResNet-50 shapes it serves (batch 8, float32 and
   bfloat16), on an odd stride-2 shape and on the full epilogue, and times
   the kernel, the plain version and ``F.conv2d`` (a yardstick only).
4. Serves ResNet-50 v1 (NHWC, 224x224, 1000 classes, seeded weights)
   through the port's bucketed Predictor on the card, in float32 and then
   bfloat16, checks the logits against the same net on the CPU and that
   every forward launched the kernel 11 times, and times each bucket.
5. Prints one JSON line of kernels, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero without the last
line. It imports nothing of JAX or of the JAX package.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,     # CUDA cores (TF32 is off by policy)
              "bfloat16": 989e12}   # dense tensor cores
# (name, batch, H=W, C_in, C_out, k, stride, pad, launches per forward)
RESNET50_GATED = [
    ("stem 7x7/2 3->64 @224", 8, 224, 3, 64, 7, 2, 3, 1),
    ("1x1 64->64 @56", 8, 56, 64, 64, 1, 1, 0, 1),
    ("3x3 64->64 @56", 8, 56, 64, 64, 3, 1, 1, 3),
    ("1x1 64->256 @56", 8, 56, 64, 256, 1, 1, 0, 4),
    ("1x1 256->64 @56", 8, 56, 256, 64, 1, 1, 0, 2),
]
REQUESTS = (1, 3, 8, 5, 11)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def cuda_ms(fn, launches=20, repeats=5, warmup=3):
    """Milliseconds per fn() call on the device: CUDA events around a run
    of back-to-back calls (so the host's launch cost overlaps the device
    work), divided by the count; the median of ``repeats`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    times.sort()
    return times[len(times) // 2]


def bound_ms(x, w, out_elems, dtype, extra_bytes=0):
    """Least time for the work: the larger of bytes over HBM bandwidth
    (each input read once, each output written once) and FLOPs over the
    card's peak for the type."""
    isz = x.element_size()
    n_bytes = (x.numel() + w.numel() + out_elems) * isz + extra_bytes
    kh, kw, cin, cout = w.shape
    flops = 2.0 * (out_elems // cout) * kh * kw * cin * cout
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(got, ref, dtype, what):
    """float32: |got-ref| <= 1e-4 + 1e-4|ref|; bfloat16 (ref computed in
    float32 from the same bf16 inputs): |got-ref| <= 1e-2 max|ref|."""
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if dtype == "float32":
        ok = bool((err <= 1e-4 + 1e-4 * ref.abs()).all())
    else:
        ok = bool(err.max() <= 1e-2 * ref.abs().max())
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: kernel disagrees with its plain version "
                             "(max abs err %.3g, max |ref| %.3g)"
                             % (what, err.max().item(), ref.abs().max().item()))
    return err.max().item()


def kernel_phase():
    import torch
    import torch.nn.functional as F
    from mxtpu_torch.ops.pallas.conv import (fused_conv, fused_conv_reference,
                                             fused_conv_with_raw)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("kernel checks against the plain version: float32 |err| <= "
          "1e-4 + 1e-4|ref|; bfloat16 max|err| <= 1e-2 max|ref|, ref in "
          "float32 from the same bf16 inputs")
    rows = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, n, hw, cin, cout, k, s, p, per_fwd in RESNET50_GATED:
            x = torch.randn(n, hw, hw, cin, device="cuda", generator=gen).to(dt)
            w = (torch.randn(k, k, cin, cout, device="cuda", generator=gen)
                 * math.sqrt(2.0 / (k * k * cin))).to(dt)
            pad = ((p, p), (p, p))
            out = fused_conv(x, w, (s, s), pad)
            torch.cuda.synchronize()
            ref = fused_conv_reference(x.float(), w.float(), (s, s), pad)[0]
            err = check(out, ref, dtype, "%s %s" % (name, dtype))
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            ms = cuda_ms(lambda: fused_conv(x, w, (s, s), pad))
            plain = cuda_ms(lambda: fused_conv_reference(x, w, (s, s), pad))
            lib = cuda_ms(lambda: F.conv2d(xn, wn, stride=s, padding=p))
            bms, by = bound_ms(x, w, out.numel(), dtype)
            rows.append(dict(shape=name, dtype=dtype, per_forward=per_fwd,
                             max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bms, bound_by=by))
            print("kernel fused_conv %-22s %-8s err %.3g  kernel %.4f ms  "
                  "plain %.4f ms  F.conv2d %.4f ms  bound %.4f ms (%s)  "
                  "x%d per forward" % (name, dtype, err, ms, plain, lib, bms,
                                       by, per_fwd), flush=True)
        # odd shape, stride 2, asymmetric padding, through the plain check
        x = torch.randn(3, 17, 13, 5, device="cuda", generator=gen).to(dt)
        w = (0.3 * torch.randn(3, 3, 5, 24, device="cuda",
                               generator=gen)).to(dt)
        pad = ((1, 0), (2, 1))
        out = fused_conv(x, w, (2, 2), pad)
        ref = fused_conv_reference(x.float(), w.float(), (2, 2), pad)[0]
        print("kernel fused_conv odd 17x13 s2 %s err %.3g" % (
            dtype, check(out, ref, dtype, "odd stride-2 " + dtype)))
        # the full epilogue: scale + bias + residual + relu, raw conv too
        x = torch.randn(2, 28, 28, 64, device="cuda", generator=gen).to(dt)
        w = (0.05 * torch.randn(3, 3, 64, 64, device="cuda",
                                generator=gen)).to(dt)
        sc = torch.rand(64, device="cuda", generator=gen) + 0.5
        bi = 0.1 * torch.randn(64, device="cuda", generator=gen)
        for res_dt in sorted({dt, torch.float32}, key=str):
            res = torch.randn(2, 28, 28, 64, device="cuda",
                              generator=gen).to(res_dt)
            pad = ((1, 1), (1, 1))
            out, craw = fused_conv_with_raw(x, w, (1, 1), pad, scale=sc,
                                            bias=bi, residual=res, relu=True)
            r_out, r_craw = fused_conv_reference(
                x.float(), w.float(), (1, 1), pad, sc, bi, res, True)
            e1 = check(out, r_out, dtype, "epilogue out " + dtype)
            e2 = check(craw, r_craw, "float32", "epilogue raw conv " + dtype)
            print("kernel fused_conv epilogue %s residual %s err out %.3g "
                  "raw %.3g" % (dtype, str(res_dt).split(".")[-1], e1, e2))
    return rows


def build_net(arrays=None):
    import numpy as np
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo import vision
    with mt.layout("NHWC"):
        net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():   # settle the deferred shapes at a small size
        net(torch.zeros(1, 32, 32, 3))
    if arrays is None:
        arrays = convert.seeded_params(
            {k: p.shape for k, p in net.collect_params().items()}, seed=0)
    convert.load_mxtpu_params(net, arrays)
    return net, arrays


def serve(pred, reqs):
    """The main path: answer every request once. Returns the outputs, the
    wall seconds and the kernel launches counted during exactly this run."""
    import torch
    from mxtpu_torch.ops.pallas.conv import fused_conv
    fused_conv.launches = 0
    t0 = time.time()
    outs = [pred.predict(x) for x in reqs]
    torch.cuda.synchronize()
    return outs, time.time() - t0, fused_conv.launches


def device_breakdown(pred, x, forwards=5):
    """Device kernel time per forward by kernel name, from torch.profiler
    (CUPTI), over ``forwards`` back-to-back predicts of ``x``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            pred.predict(x)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / forwards,
                    e.count / forwards) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    return rows


def serve_phase(card):
    """Serve resnet50_v1 in f32, then bf16; returns the fused-conv launches
    each main-path run counted."""
    import numpy as np
    import torch
    from mxtpu_torch.serving import BucketSpec, Predictor
    spec = BucketSpec.pow2(8)
    dispatches = sum(-(-b // spec.max_batch) for b in REQUESTS)
    rng = np.random.default_rng(1)
    reqs = [rng.standard_normal((b, 224, 224, 3)).astype(np.float32)
            for b in REQUESTS]
    net, arrays = build_net()
    cpu_net, _ = build_net(arrays)
    cpu_pred = Predictor(cpu_net, spec, device="cpu")
    launches_by_dtype = {}
    for dtype, tol in (("float32", 1e-3), ("bfloat16", 5e-2)):
        dt = getattr(torch, dtype)
        if dtype == "bfloat16":
            net.cast("bfloat16")
            cpu_net.cast("bfloat16")
        t0 = time.time()
        pred = Predictor(net, spec, example=torch.zeros(1, 224, 224, 3,
                                                        dtype=dt),
                         warmup=True, device="cuda")
        warm_s = time.time() - t0
        xs = [torch.from_numpy(x).to(dt) for x in reqs]
        outs, wall, launches = serve(pred, xs)
        if launches != 11 * dispatches:
            raise AssertionError("%s: fused_conv launched %d times over %d "
                                 "forwards, expected %d" % (
                                     dtype, launches, dispatches,
                                     11 * dispatches))
        errs = []
        for x, out in zip(xs, outs):
            ref = cpu_pred.predict(x).float()
            got = out.float().cpu()
            if tuple(got.shape) != (x.shape[0], 1000) or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError("%s: bad logits %s" % (dtype,
                                                            tuple(got.shape)))
            err = (got - ref).abs().max().item() / ref.abs().max().item()
            if err > tol:
                raise AssertionError("%s: logits differ from the CPU run by "
                                     "%.3g of max|logit| (limit %g)"
                                     % (dtype, err, tol))
            errs.append(err)
        print("serve resnet50_v1 %s: warmup %.2f s, %d requests %s in %.3f s, "
              "fused_conv launches %d (= 11 x %d forwards), max rel err vs "
              "CPU %.3g" % (dtype, warm_s, len(REQUESTS), list(REQUESTS),
                            wall, launches, dispatches, max(errs)))
        # closed loop, one client: each request's wall time, synchronised;
        # 50 samples give a p80 with 10 samples beyond it
        per_bucket, latency = {}, {}
        for b in spec.buckets():
            x = xs[-1][:b].to("cuda")
            for _ in range(3):
                pred.predict(x)
            torch.cuda.synchronize()
            samples, enqueue = [], []
            for _ in range(50):
                t0 = time.perf_counter()
                pred.predict(x)
                t1 = time.perf_counter()   # the host has issued the forward
                torch.cuda.synchronize()
                samples.append(1e3 * (time.perf_counter() - t0))
                enqueue.append(1e3 * (t1 - t0))
            samples.sort()
            enqueue.sort()
            latency[b] = (samples[25], samples[40], enqueue[25])
            per_bucket[b] = 1e3 * b / samples[25]
        print("serve resnet50_v1 %s on %s, per bucket: images/s at the "
              "median latency (median ms, p80 ms, median host-issue ms; "
              "50 requests): %s" % (dtype, card, ", ".join(
                  "b%d %.1f (%.3f, %.3f, %.3f)" % ((b, per_bucket[b])
                                                   + latency[b])
                  for b in spec.buckets())), flush=True)
        b = spec.max_batch
        rows = device_breakdown(pred, xs[-1][:b].to("cuda"))
        dev_ms = sum(r[1] for r in rows)
        wall_ms = latency[b][0]
        conv_ms = sum(r[1] for r in rows if "fused_conv_kernel" in r[0])
        if dev_ms > 0:
            print("serve resnet50_v1 %s b%d per forward: wall %.3f ms "
                  "(median, unprofiled), device kernels %.3f ms (idle share "
                  "%.3f), fused_conv kernel %.3f ms, %d kernel launches" % (
                      dtype, b, wall_ms, dev_ms, 1 - dev_ms / wall_ms,
                      conv_ms, round(sum(r[2] for r in rows))))
            for name, ms, count in rows[:8]:
                print("  %.4f ms  x%-4g %s" % (ms, count, name[:110]))
        else:
            print("serve resnet50_v1 %s: device time not measured "
                  "(torch.profiler saw no CUDA kernels)" % dtype)
        launches_by_dtype[dtype] = launches
    return launches_by_dtype


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = card_line()
    print("card:", card, flush=True)
    sys.path.insert(0, ROOT)
    import mxtpu_torch  # noqa: F401  (applies the precision policy)
    from mxtpu_torch import kernels
    print("torch %s, CUDA %s, python %s" % (torch.__version__,
                                            torch.version.cuda,
                                            sys.version.split()[0]))
    t0 = time.time()
    names = kernels.build_all()
    print("built %s from mxtpu_torch/csrc with nvcc for sm_90a in %.1f s"
          % (names, time.time() - t0), flush=True)
    for name in names:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas %s: %s" % (name, line.strip()))
    rows = kernel_phase()
    launches = serve_phase(card)
    kernels_line = {"kernels": []}
    for dtype in ("float32", "bfloat16"):
        mine = [r for r in rows if r["dtype"] == dtype]
        tot = {key: sum(r[key] * r["per_forward"] for r in mine)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_bytes = sum(r["bound_ms"] * r["per_forward"] for r in mine
                       if r["bound_by"] == "bytes")
        kernels_line["kernels"].append({
            "name": "fused_conv (%s, the 11 gated convs of one b8 "
                    "ResNet-50 forward)" % dtype,
            "route": "cuda",
            "source": "mxtpu_torch/csrc/fused_conv.cu",
            "replaces": "mxtpu/ops/pallas/conv.py:313",
            "launches": launches[dtype],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            # the kind that bounds the larger share of the summed bound
            "bound_by": ("bytes" if 2 * by_bytes >= tot["bound_ms"]
                         else "operations"),
            "library_ms": tot["library_ms"],
        })
    print(json.dumps(kernels_line))
    print("card:", card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
