"""The Inception v3 f32 captured-training lockstep of
``chip_smoke.zoo_train_phase`` (3 SGD steps at b2, 299², each against the
CPU and the card's eager step from the card's state), run ``RUNS`` times
with cuDNN's default algorithms and ``RUNS`` times deterministic: each
step's per-sample loss margin (of the loss's scale; the gate is 1e-5);
then, after two steps, step 3's forward on the card (eager) and on the
CPU from the card's weights, every leaf block's output compared (the
first layer past 64 ulps of float32, the largest growths). One JSON line
per run and per layer comparison, on stdout and in ``OUT``.

    python3 lockstep_margins.py [RUNS] [OUT]
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402
import chip_smoke as c  # noqa: E402
import mxtpu_torch as mt  # noqa: E402
from mxtpu_torch import kernels  # noqa: E402
from mxtpu_torch.ops.pallas.conv import fused_conv  # noqa: E402

RUNS = int(sys.argv[1]) if len(sys.argv) > 1 else 3
OUT = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
    ROOT, "build", "lockstep_margins.jsonl")


def emit(rec):
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(OUT)), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(rec) + "\n")


def nets(arrays):
    gpu = mt.gpu(0)
    cpu_net = c.build_zoo("inception_v3", 299, arrays)[0]
    g = c.build_zoo("inception_v3", 299, arrays)[0]
    g.collect_params().reset_ctx(gpu)
    g.hybridize()
    e = c.build_zoo("inception_v3", 299, arrays)[0]
    e.collect_params().reset_ctx(gpu)
    for n in (g, e, cpu_net):
        c._dropouts(n, 0.0)
    return g, e, cpu_net


def batches():
    rng = np.random.default_rng(41)
    return [(rng.standard_normal((2, 299, 299, 3)).astype(np.float32),
             rng.integers(0, 1000, 2).astype(np.float32))
            for _ in range(5)]


def one_run(arrays, mode, i):
    g, e, cpu_net = nets(arrays)
    margins = []
    t0 = time.time()
    ctx = c._deterministic() if mode == "deterministic" else None
    err = None
    try:
        if ctx:
            ctx.__enter__()
        c.lockstep_train("inception_v3 %s %d" % (mode, i), g, cpu_net,
                         batches()[:3], "sgd", c.SGD_PARAMS,
                         kernel=fused_conv, eager_net=e, trainers={},
                         clip=c.CLIP_NORM, l2_tol=c.INCEPTION_TRAIN_L2,
                         margins=margins)
    except AssertionError as ex:
        err = str(ex)
    finally:
        if ctx:
            ctx.__exit__(None, None, None)
    emit({"mode": mode, "run": i, "s": round(time.time() - t0, 1),
          "margins": margins, "miss": err})
    del g, e, cpu_net
    torch.cuda.empty_cache()


def layers(arrays, mode):
    """Two lockstep steps, then step 3's forward on the card eagerly and
    on the CPU from the card's weights, each leaf block's output compared."""
    g, e, cpu_net = nets(arrays)
    ctx = c._deterministic() if mode == "deterministic" else None
    if ctx:
        ctx.__enter__()
    try:
        c.lockstep_train("inception_v3 layers", g, cpu_net, batches()[:2], "sgd",
                         c.SGD_PARAMS, kernel=fused_conv, eager_net=e,
                         trainers={}, clip=c.CLIP_NORM,
                         l2_tol=c.INCEPTION_TRAIN_L2)
    except AssertionError as ex:
        print("layers lockstep:", ex)
    for net in (e, cpu_net):
        for cp, h in zip(g.collect_params().values(),
                         net.collect_params().values()):
            h.set_data(cp.data().to_torch().detach())
    x, y = batches()[2]
    outs = {}

    def hook_for(tag, name):
        def hook(block, inp, out):
            o = out[0] if isinstance(out, (tuple, list)) else out
            o = o._data if hasattr(o, "_data") else o
            outs.setdefault(tag, []).append(
                (name, o.detach().float().cpu().numpy()))
        return hook
    handles = []
    for tag, net in (("card", e), ("cpu", cpu_net)):
        for name, m in net.named_modules():
            if len(list(m.children())) == 0 and hasattr(
                    m, "register_forward_hook"):
                handles.append(m.register_forward_hook(hook_for(tag, name)))
    for tag, net, dev in (("card", e, mt.gpu(0)), ("cpu", cpu_net,
                                                     mt.cpu())):
        xa = mt.nd.array(x, ctx=dev)
        with mt.autograd.record():
            net(xa)
    if ctx:
        ctx.__exit__(None, None, None)
    rows, prev = [], 0.0
    for (name, a), (_, b) in zip(outs["card"], outs["cpu"]):
        scale = float(np.abs(b).max()) or 1.0
        err = float(np.abs(a - b).max()) / scale
        rows.append((name, a.shape, err, err / prev if prev else None))
        prev = max(err, 1e-12)
    eps = float(np.finfo(np.float32).eps)
    first = next((r for r in rows if r[2] > 64 * eps), None)
    top = sorted((r for r in rows if r[3]), key=lambda r: -r[3])[:8]
    emit({"mode": mode, "layers": len(rows), "first_over_64eps": first and
          [first[0], list(first[1]), first[2]],
          "final": rows[-1][2],
          "largest_growth": [[r[0], r[2], r[3]] for r in top],
          "all": [[r[0], r[2]] for r in rows]})
    for h in handles:
        h.detach()


def main():
    kernels.build_all()
    print("card:", c.card_line(), flush=True)
    _, arrays = c.build_zoo("inception_v3", 299)
    for i in range(RUNS):
        one_run(arrays, "default", i)
    for i in range(RUNS):
        one_run(arrays, "deterministic", i)
    for mode in ("default", "deterministic"):
        try:
            layers(arrays, mode)
        except Exception as ex:  # noqa: BLE001
            print("layers %s failed: %r" % (mode, ex), flush=True)


if __name__ == "__main__":
    main()
