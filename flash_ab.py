#!/usr/bin/env python3
"""A/B of the port's kernels and of the served models across checkouts of
this repo, on one NVIDIA card:

    python3 flash_ab.py [--conv | --rtc] NAME=DIR NAME=DIR [...]

runs each checkout's ``mxtpu_torch`` in a fresh process of its own, in the
order A B ... B A (each checkout twice, mirrored, so a drift of the card or
the host over the call falls on both alike). Without ``--conv`` each run

* holds the flash kernel against its plain version, then times it at
  b8 h12 T512 d64 on the strided q/k/v views the served model hands it,
  bfloat16 and float32: the eager back-to-back ms (``chip_smoke.cuda_ms``,
  the yardstick of the ``kernels`` line), the device ms by CUDA-graph
  replay (``chip_smoke.graph_ms``) and the host us to issue one call
  (``chip_smoke.host_us``), with ``F.scaled_dot_product_attention`` timed
  the same three ways;
* serves the BERT-base TransformerLM (seeded weights) at b8 x 512 through
  the Predictor, float32 then bfloat16.

With ``--conv`` each run

* holds the fused conv kernel against its plain version at the 5 gated
  ResNet-50 shapes (batch 8), bfloat16 and float32, and times each by
  graph replay, eagerly and by host us, with ``F.conv2d`` beside it; the
  sums over the 11 gated launches of one forward;
* serves ResNet-50 v1 (seeded weights) at b8 through the Predictor,
  float32 then bfloat16.

With ``--rtc`` each run builds the checkout's own ``chip_smoke.py``
runtime examples (kernel B3, ``RTC_SOURCE``) through its ``mxtpu_torch.rtc``
and launches them as that checkout does (its ``rtc_launch`` where it has
one, else the default one-thread-per-element grid):

* holds each against its plain version at n = 25,557,032 and times it
  eagerly, with its one-call PyTorch equivalent beside it;
* the host us to issue one launch of square at n = 1024, with
  ``torch.square``'s beside it;
* the median wall ms of one imperative autograd step (square registered
  as a differentiable op through ``contrib.external_kernel``, times w,
  summed, backward) at n = 25,557,032 and at n = 1024, where the host's
  issue is all of it.

A serve reports the median and p80 latency and the median host-issue ms
of 50 closed-loop requests (``chip_smoke.closed_loop``), the kernel's
launches per forward, and the device ms per forward, the kernel's share
of it and the idle share (``chip_smoke.device_breakdown``).

The measuring helpers come from the ``chip_smoke.py`` beside this script,
the package from the checkout under test. Prints one line per run and a
table of each metric by checkout.
"""
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TAG = "AB_RESULT "


def load(tree):
    """chip_smoke (beside this script) with the checkout at ``tree`` first
    on the path; returns (chip_smoke, tree)."""
    tree = os.path.realpath(tree)
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.realpath(p or ".") != HERE]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import mxtpu_torch
    if not os.path.realpath(mxtpu_torch.__file__).startswith(tree + os.sep):
        raise AssertionError("imported %s, not the checkout %s"
                             % (mxtpu_torch.__file__, tree))
    return cs, tree


def serve_row(cs, pred, x, kernel, per_forward, key):
    """One forward's launches of ``kernel`` (must be ``per_forward``), then
    the closed-loop latency and the profiler's device time of ``x``."""
    import torch
    kernel.launches = 0
    out = pred.predict(x)
    out = out.to_torch() if hasattr(out, "to_torch") else out  # NDArray
    torch.cuda.synchronize()
    if kernel.launches != per_forward or \
            not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("%d launches in one forward (expected %d), or "
                             "outputs not finite" % (kernel.launches,
                                                     per_forward))
    launches = kernel.launches
    med, p80, host = cs.closed_loop(pred, x)
    rows = cs.device_breakdown(pred, x, forwards=3)
    dev = sum(r[1] for r in rows)
    mine = sum(r[1] for r in rows if key in r[0])
    return {"median_ms": med, "p80_ms": p80, "host_issue_ms": host,
            "device_ms": dev, "kernel_ms": mine, "idle_share": 1 - dev / med,
            "launches": launches}


def flash_worker(tree):
    """One flash run against the checkout at ``tree``."""
    cs, tree = load(tree)
    import torch
    import torch.nn.functional as F
    from mxtpu_torch import kernels
    from mxtpu_torch.ops.pallas.flash_attention import (
        flash_attention, flash_attention_reference, flash_attention_with_lse)
    from mxtpu_torch.serving import BucketSpec, Predictor
    kernels.build_all(["flash_attention"])
    res = {"tree": tree}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    for dtype in ("bfloat16", "float32"):
        q, k, v = cs.flash_inputs(8, 12, 512, 512, 64, getattr(torch, dtype),
                                  "qkv", gen)
        out, _ = flash_attention_with_lse(q, k, v, False)
        ref, _ = flash_attention_reference(q.float(), k.float(), v.float())
        err = cs.check(out, ref, dtype, "flash %s" % dtype)
        kern = lambda: flash_attention_with_lse(q, k, v, False)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)
        res["flash " + dtype] = {
            "err": err, "eager_ms": cs.cuda_ms(kern),
            "graph_ms": cs.graph_ms(kern), "host_us": cs.host_us(kern),
            "sdpa_eager_ms": cs.cuda_ms(sdpa),
            "sdpa_graph_ms": cs.graph_ms(sdpa),
            "sdpa_host_us": cs.host_us(sdpa)}
    net, _ = cs.build_lm()
    spec = BucketSpec.pow2(8, seq_lens=cs.SEQ_BUCKETS)
    x = torch.randint(0, cs.BERT_BASE["vocab_size"], (8, 512),
                      generator=torch.Generator().manual_seed(3),
                      dtype=torch.int32).to("cuda")
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            net.cast("bfloat16")
        pred = Predictor(net, spec, device="cuda")
        res["serve " + dtype] = serve_row(
            cs, pred, x, flash_attention, cs.BERT_BASE["num_layers"],
            "flash_attention_")
    return res


def conv_worker(tree):
    """One fused-conv run against the checkout at ``tree``."""
    cs, tree = load(tree)
    import math
    import numpy as np
    import torch
    import torch.nn.functional as F
    from mxtpu_torch import kernels
    from mxtpu_torch.ops.pallas.conv import fused_conv, fused_conv_reference
    from mxtpu_torch.serving import BucketSpec, Predictor
    kernels.build_all(["fused_conv"])
    res = {"tree": tree}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        row = {"err": 0.0, "graph_ms": 0.0, "conv2d_graph_ms": 0.0,
               "eager_ms": 0.0, "conv2d_eager_ms": 0.0, "host_us": 0.0,
               "conv2d_host_us": 0.0}
        for name, n, hw, cin, cout, k, s, p, per in cs.RESNET50_GATED:
            x = torch.randn(n, hw, hw, cin, device="cuda",
                            generator=gen).to(dt)
            w = (torch.randn(k, k, cin, cout, device="cuda", generator=gen)
                 * math.sqrt(2.0 / (k * k * cin))).to(dt)
            pad = ((p, p), (p, p))
            out = fused_conv(x, w, (s, s), pad)
            ref = fused_conv_reference(x.float(), w.float(), (s, s), pad)[0]
            row["err"] = max(row["err"], cs.check(out, ref, dtype, name))
            xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
            kern = lambda: fused_conv(x, w, (s, s), pad)
            lib = lambda: F.conv2d(xn, wn, stride=s, padding=p)
            g = cs.graph_ms(kern)
            row[name + " graph_ms"] = g
            row["graph_ms"] += per * g
            row["conv2d_graph_ms"] += per * cs.graph_ms(lib)
            row["eager_ms"] += per * cs.cuda_ms(kern)
            row["conv2d_eager_ms"] += per * cs.cuda_ms(lib)
            row["host_us"] += per * cs.host_us(kern)
            row["conv2d_host_us"] += per * cs.host_us(lib)
        res["conv " + dtype] = row
    net, _ = cs.build_net()
    spec = BucketSpec.pow2(8)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 224, 224, 3)).astype(np.float32)).to("cuda")
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            net.cast("bfloat16")
        pred = Predictor(net, spec, device="cuda")
        res["serve " + dtype] = serve_row(
            cs, pred, x.to(getattr(torch, dtype)), fused_conv, 11,
            "fused_conv_")
    return res


def tree_chip_smoke(tree):
    """The checkout's own chip_smoke.py (its runtime examples)."""
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rtc_worker(tree):
    """One run of the checkout's runtime examples at ``tree``."""
    cs, tree = load(tree)
    import time
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import rtc
    from mxtpu_torch.contrib.external_kernel import register_external_kernel
    tcs = tree_chip_smoke(tree)
    mod = rtc.CudaModule(tcs.RTC_SOURCE).build()
    ks = {name: mod.get_kernel(name) for name, *_ in tcs.RTC_KERNELS}
    types = {name: dtype for name, _, dtype, *_ in tcs.RTC_KERNELS}

    def launch(name, args, shape):
        n = 1
        for s in shape:
            n *= s
        if hasattr(tcs, "rtc_launch"):
            return tcs.rtc_launch(ks[name], args, n, types[name], shape)
        return ks[name].launch(args, shape)

    res = {"tree": tree}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    n = 25557032
    for name, n_in, dtype, rule, library in tcs.RTC_KERNELS:
        xs = [torch.randn(n, device="cuda", generator=gen).to(
            getattr(torch, dtype)) for _ in range(n_in)]
        plain = tcs.RTC_PLAIN[name]
        out = launch(name, xs + [n], (n,)).to_torch()
        err = cs.rtc_check(out, plain(*xs), rule, name,
                           mag=plain(*[t.abs() for t in xs]))
        row = {"err": err,
               "eager_ms": cs.cuda_ms(lambda: launch(name, xs + [n], (n,)))}
        if library is not None:
            row["torch_ms"] = cs.cuda_ms(lambda: library(*xs))
        res["rtc " + name] = row
    small = torch.randn(1024, device="cuda", generator=gen)
    host = {"rtc_square_us": cs.host_us(
        lambda: launch("square", [small, 1024], (1024,))),
        "torch_square_us": cs.host_us(small.square)}
    register_external_kernel(
        "ab_square", lambda x: launch("square", [x, x.numel()], x.shape),
        vjp=lambda g, x: launch("square_backward", [x, g, x.numel()],
                                x.shape))
    for m in (n, 1024):
        x = mt.nd.array(torch.randn(m, device="cuda", generator=gen))
        w = mt.nd.array(torch.randn(m, device="cuda", generator=gen))
        x.attach_grad()
        w.attach_grad()

        def step():
            with mt.autograd.record():
                loss = (mt.nd.ab_square(x) * w).sum()
            loss.backward()
        for _ in range(3):
            step()
        samples = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            samples.append(1e3 * (time.perf_counter() - t0))
        samples.sort()
        host["autograd_step_ms n=%d" % m] = samples[len(samples) // 2]
    res["host"] = host
    return res


WORKERS = {"flash": flash_worker, "conv": conv_worker, "rtc": rtc_worker}


def main(argv):
    if len(argv) >= 3 and argv[0] == "--run":
        res = WORKERS[argv[2]](argv[1])
        print(TAG + json.dumps(res), flush=True)
        return 0
    mode = "flash"
    if argv and argv[0] in ("--conv", "--rtc"):
        mode, argv = argv[0][2:], argv[1:]
    trees = [a.split("=", 1) for a in argv]
    if len(trees) < 2 or any(len(t) != 2 for t in trees):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    print("card: " + cs.card_line(), flush=True)
    runs = []
    for name, tree in trees + trees[::-1]:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--run", tree, mode], capture_output=True,
                           text=True, timeout=900)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith(TAG)]
        if p.returncode != 0 or not lines:
            print("run %s (%s) failed, rc %d:\n%s" % (
                name, tree, p.returncode, p.stderr[-4000:]), flush=True)
            return 1
        res = json.loads(lines[-1][len(TAG):])
        runs.append((name, res))
        print("run %s %s" % (name, json.dumps(res)), flush=True)
    for part in runs[0][1]:
        if part == "tree":
            continue
        for key in runs[0][1][part]:
            print("%-15s %-24s %s" % (part, key, "  ".join(
                "%s %.6g" % (name, res[part][key]) for name, res in runs
                if key in res.get(part, {}))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
