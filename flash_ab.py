#!/usr/bin/env python3
"""A/B of the flash attention kernel and of the TransformerLM serve across
checkouts of this repo, on one NVIDIA card:

    python3 flash_ab.py NAME=DIR NAME=DIR [...]

runs each checkout's ``mxtpu_torch`` in a fresh process of its own, in the
order A B ... B A (each checkout twice, mirrored, so a drift of the card or
the host over the call falls on both alike). Each run

* holds the flash kernel against its plain version, then times it at
  b8 h12 T512 d64 on the strided q/k/v views the served model hands it,
  bfloat16 and float32: the eager back-to-back ms (``chip_smoke.cuda_ms``,
  the yardstick of the ``kernels`` line), the device ms by CUDA-graph
  replay (``chip_smoke.graph_ms``) and the host us to issue one call
  (``chip_smoke.host_us``), with ``F.scaled_dot_product_attention`` timed
  the same three ways;
* serves the BERT-base TransformerLM (seeded weights) at b8 x 512 through
  the Predictor, float32 then bfloat16: the median and p80 latency and the
  median host-issue ms of 50 closed-loop requests
  (``chip_smoke.closed_loop``), the flash launches per forward, and the
  device ms per forward, flash's share of it and the idle share
  (``chip_smoke.device_breakdown``).

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


def worker(tree):
    """One run against the checkout at ``tree``; prints one TAG line."""
    tree = os.path.realpath(tree)
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.realpath(p or ".") != HERE]
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    import torch.nn.functional as F
    import mxtpu_torch
    if not os.path.realpath(mxtpu_torch.__file__).startswith(tree + os.sep):
        raise AssertionError("imported %s, not the checkout %s"
                             % (mxtpu_torch.__file__, tree))
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
        flash_attention.launches = 0
        logits = pred.predict(x)
        torch.cuda.synchronize()
        if flash_attention.launches != cs.BERT_BASE["num_layers"] or \
                not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError("%s: %d flash launches in one forward, or "
                                 "logits not finite" % (dtype,
                                                        flash_attention.launches))
        med, p80, host = cs.closed_loop(pred, x)
        rows = cs.device_breakdown(pred, x, forwards=3)
        dev = sum(r[1] for r in rows)
        fl = sum(r[1] for r in rows if "flash_attention_" in r[0])
        res["serve " + dtype] = {
            "median_ms": med, "p80_ms": p80, "host_issue_ms": host,
            "device_ms": dev, "flash_ms": fl, "idle_share": 1 - dev / med,
            "flash_launches": flash_attention.launches}
    print(TAG + json.dumps(res), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--run":
        worker(argv[1])
        return 0
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
                            "--run", tree], capture_output=True, text=True,
                           timeout=900)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith(TAG)]
        if p.returncode != 0 or not lines:
            print("run %s (%s) failed, rc %d:\n%s" % (
                name, tree, p.returncode, p.stderr[-4000:]), flush=True)
            return 1
        res = json.loads(lines[-1][len(TAG):])
        runs.append((name, res))
        print("run %s %s" % (name, json.dumps(res)), flush=True)
    for part in ("flash bfloat16", "flash float32", "serve bfloat16",
                 "serve float32"):
        for key in runs[0][1][part]:
            print("%-15s %-16s %s" % (part, key, "  ".join(
                "%s %.6g" % (name, res[part][key]) for name, res in runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
