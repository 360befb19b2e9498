#!/usr/bin/env python3
"""How reproducible ResNet-50's training numbers are, on the CPU: the
measurement behind ``chip_smoke.py``'s training gates (TRAIN_L2,
BF16_VS_F32).

``python3 train_sensitivity.py`` builds ``chip_smoke.py``'s seeded
ResNet-50 v1 (NHWC, 224², 1000 classes) and its b8 batch
(``python3 train_sensitivity.py inception``: the seeded Inception v3 of
``chip_smoke.zoo_train_phase``, 299², its Dropout at rate 0, and its
first b2 batch), and prints for the step-1 gradients
(SoftmaxCrossEntropyLoss, training-mode BatchNorm):

* float32 with all CPU threads against one thread (summation order only);
* float32 against float64 (BatchNorm in float64 too), and the same with a
  two-pass BatchNorm variance in float32;

each as the relative L2 error per parameter (median and worst) and the
largest elementwise error of max(1, max|ref|); and the training-mode and
inference-mode logits of bfloat16 against float32. Runs on the CPU only
(17 s on the 8 cores of the machine that holds the H100); imports
nothing of JAX.
"""
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def _step1_grads(net, x, y, dtype):
    """Step-1 gradients of the softmax CE mean over the batch, keyed
    without the net's prefix, as float64 numpy; and the loss."""
    import mxtpu_torch as mt
    params = {k.partition("_")[2]: p for k, p in
              net.collect_params().items() if p.grad_req != "null"}
    with mt.autograd.train_mode():
        logits = net(torch.from_numpy(x).to(dtype))
        loss = torch.nn.functional.cross_entropy(
            logits.float() if dtype != torch.float64 else logits,
            torch.from_numpy(y).long())
    grads = torch.autograd.grad(loss, [p._tensor() for p in
                                       params.values()])
    return {k: g.double().numpy() for k, g in zip(params, grads)}, \
        float(loss.detach())


def _batchnorm(compute_dtype, two_pass):
    """The port's training-mode BatchNorm op, computing in
    ``compute_dtype``, with the one-pass or the two-pass variance."""
    def op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
           momentum=0.9, fix_gamma=True, use_global_stats=False,
           output_mean_var=False, axis=1, cudnn_off=False):
        ax = axis % data.ndim
        shape = [1] * data.ndim
        shape[ax] = data.shape[ax]
        red = [i for i in range(data.ndim) if i != ax]
        g = torch.ones_like(gamma) if fix_gamma else gamma
        x = data.to(compute_dtype)
        mean = x.mean(dim=red)
        if two_pass:
            var = (x - mean.reshape(shape)).square().mean(dim=red)
        else:
            var = torch.clamp_min(x.square().mean(dim=red) - mean.square(),
                                  0.0)
        out = (x - mean.reshape(shape)) * (
            torch.rsqrt(var + eps) * g.to(compute_dtype)).reshape(shape) \
            + beta.to(compute_dtype).reshape(shape)
        out = out.to(data.dtype)
        return (out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)) \
            if output_mean_var else out
    return op


def _compare(label, got, ref):
    rl2 = sorted(float(np.linalg.norm((got[k] - ref[k]).ravel())
                       / np.linalg.norm(ref[k].ravel())) for k in ref)
    worst = max((float(np.abs(got[k] - ref[k]).max()
                       / max(1.0, np.abs(ref[k]).max())), k) for k in ref)
    print("%s: step-1 gradients, relative L2 median %.4g worst %.4g; "
          "elementwise worst %.4g of max(1, max|ref|) (%s)"
          % (label, rl2[len(rl2) // 2], rl2[-1], worst[0], worst[1]),
          flush=True)


def _inception(arrays=None):
    net, arrays = cs.build_zoo("inception_v3", 299, arrays)
    cs._dropouts(net, 0.0)
    return net, arrays


def main():
    import mxtpu_torch as mt
    ops = sys.modules["mxtpu_torch.ops"]
    t0 = time.time()
    if sys.argv[1:] == ["inception"]:
        rng = np.random.default_rng(41)   # zoo_train_phase's first batch
        x = rng.standard_normal((2, 299, 299, 3)).astype(np.float32)
        y = rng.integers(0, 1000, 2).astype(np.float32)
        build = _inception
    else:
        (x, y), = cs.resnet_batches(8, 1, 11)
        build = cs.build_net
    threads = torch.get_num_threads()
    runs = {}
    for n in (threads, 1):
        torch.set_num_threads(n)
        net, arrays = build()
        runs[n] = _step1_grads(net, x, y, torch.float32)
    torch.set_num_threads(threads)
    _compare("float32, %d threads against 1" % threads, runs[threads][0],
             runs[1][0])
    plain = ops.BatchNorm
    try:
        ops.BatchNorm = _batchnorm(torch.float64, two_pass=False)
        net64, _ = build(arrays)
        net64.cast("float64")
        g64, loss64 = _step1_grads(net64, x, y, torch.float64)
        ops.BatchNorm = _batchnorm(torch.float32, two_pass=True)
        net2, _ = build(arrays)
        g2, _ = _step1_grads(net2, x, y, torch.float32)
    finally:
        ops.BatchNorm = plain
    print("step-1 loss float32 %.7g, float64 %.7g" % (runs[threads][1],
                                                      loss64))
    _compare("float32 against float64", runs[threads][0], g64)
    _compare("float32 two-pass BatchNorm against float64", g2, g64)
    net16, _ = build(arrays)
    net16.cast("bfloat16")
    net32, _ = build(arrays)
    for mode, scope in (("training", mt.autograd.train_mode),
                        ("inference", mt.autograd.predict_mode)):
        with torch.no_grad(), scope():
            ref = net32(torch.from_numpy(x)).numpy()
            got = net16(torch.from_numpy(x).bfloat16()).float().numpy()
        print("%s-mode logits, bfloat16 against float32: %.4g of "
              "max|logit|" % (mode, np.abs(got - ref).max()
                              / np.abs(ref).max()))
    print("train_sensitivity %.1f s on the CPU (%d threads)"
          % (time.time() - t0, threads))
    return 0


if __name__ == "__main__":
    sys.exit(main())
