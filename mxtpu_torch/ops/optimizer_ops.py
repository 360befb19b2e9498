"""Optimizer-update ops (counterpart of ``mxtpu/ops/optimizer_ops.py``).

MXNet's update rules, not ``torch.optim``'s: for example SGD with momentum
is ``mom = momentum * mom - lr * (rescale * g + wd * w); w += mom``. Each
``*_update_fn`` is a pure function of tensors that returns the new values;
the registered ``*_update`` ops (``mx.nd.sgd_update`` and the rest) take
NDArrays and write the new weight and states into them in place, under
``torch.no_grad()``, so an optimizer step keeps a parameter's own
``nn.Parameter`` leaf.

``_rescale_clip`` keeps the reference's order: rescale, then clip, then
add ``wd * w``, the add skipped for a Python-float ``wd`` of 0 (so that
``0 * inf`` gives no NaN). A square is written ``g * g``, which
``optimizer_fused`` repeats with ``torch._foreach_mul``, so the two paths
give the same bits on the CPU.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update_fn", "sgd_mom_update_fn", "nag_mom_update_fn",
           "adam_update_fn", "rmsprop_update_fn", "rmspropalex_update_fn",
           "ftrl_update_fn", "adagrad_update_fn", "signsgd_update_fn",
           "signum_update_fn", "ftml_update_fn", "write"]


def _rescale_clip(grad, rescale_grad, clip_gradient, wd=None, weight=None):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    if wd is None or weight is None:
        return g
    if isinstance(wd, (int, float)) and wd == 0.0:
        return g
    return g + weight * wd


def _sign(x):
    """jnp.sign: NaN stays NaN, zero keeps its sign."""
    s = torch.sign(x)
    return torch.where(s == 0, x, s)


def sgd_update_fn(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=False):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    return weight - g * lr


def sgd_mom_update_fn(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=False):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    mom_new = mom * momentum - g * lr
    return weight + mom_new, mom_new


def nag_mom_update_fn(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    mom_new = mom * momentum + g
    return weight - (mom_new * momentum + g) * lr, mom_new


def adam_update_fn(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                   epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   lazy_update=False):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    mean_new = mean * beta1 + g * (1 - beta1)
    var_new = var * beta2 + (g * g) * (1 - beta2)
    return (weight - (mean_new * lr) / (torch.sqrt(var_new) + epsilon),
            mean_new, var_new)


def rmsprop_update_fn(weight, grad, n, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    n_new = (g * g) * (1 - gamma1) + n * gamma1
    w = weight - (g * lr) / torch.sqrt(n_new + epsilon)
    if clip_weights and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_new


def rmspropalex_update_fn(weight, grad, n, g_avg, delta, lr, gamma1=0.95,
                          gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0, clip_weights=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    n_new = (g * g) * (1 - gamma1) + n * gamma1
    g_avg_new = g * (1 - gamma1) + g_avg * gamma1
    delta_new = delta * gamma2 - (g * lr) / torch.sqrt(
        n_new - g_avg_new * g_avg_new + epsilon)
    w = weight + delta_new
    if clip_weights and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n_new, g_avg_new, delta_new


def ftrl_update_fn(weight, grad, z, n, lr, lamda1=0.01, beta=1.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    w = torch.where(
        torch.abs(z_new) > lamda1,
        -(z_new - _sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd),
        torch.zeros_like(z_new))
    return w.to(weight.dtype), z_new, n_new


def adagrad_update_fn(weight, grad, history, lr, epsilon=1e-7, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    hist_new = history + g * g
    w = weight - (g / torch.sqrt(hist_new + epsilon) + weight * wd) * lr
    return w, hist_new


def signsgd_update_fn(weight, grad, lr, wd=0.0, rescale_grad=1.0,
                      clip_gradient=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient)
    return weight - (_sign(g) + weight * wd) * lr


def signum_update_fn(weight, grad, mom, lr, momentum=0.9, wd=0.0,
                     rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _rescale_clip(grad, rescale_grad, clip_gradient, wd, weight)
    mom_new = mom * momentum - g * (1 - momentum)
    w = weight * (1 - lr * wd_lh) + _sign(mom_new) * lr
    return w, mom_new


def ftml_update_fn(weight, grad, d, v, z, lr, t, beta1=0.6, beta2=0.999,
                   epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    g = _rescale_clip(grad, rescale_grad, clip_grad, wd, weight)
    v_new = v * beta2 + (g * g) * (1 - beta2)
    d_new = (torch.sqrt(v_new / (1 - beta2 ** t)) + epsilon) \
        * ((1 - beta1 ** t) / lr)
    sigma = d_new - d * beta1
    z_new = z * beta1 + g * (1 - beta1) - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new


def write(arr, value):
    """Write ``value`` into the NDArray ``arr`` in place (its own tensor,
    in its dtype), outside autograd."""
    with torch.no_grad():
        arr._data.copy_(value)
    arr._version += 1


def _mutating(fn, n_state):
    """The mx.nd-style op: the weight (and the states) updated in place."""
    def wrapper(weight, grad, *states_and_args, out=None, **kwargs):
        states = list(states_and_args[:n_state])
        args = states_and_args[n_state:]
        with torch.no_grad():
            res = fn(weight._data.detach(), grad._data.detach(),
                     *[s._data.detach() for s in states], *args, **kwargs)
        if n_state == 0:
            write(weight, res)
        else:
            write(weight, res[0])
            for s, new in zip(states, res[1:]):
                write(s, new)
        return weight
    wrapper.__name__ = fn.__name__[:-len("_fn")]
    wrapper.__doc__ = "In-place form of ``%s``." % fn.__name__
    return wrapper


sgd_update = register("sgd_update", wrap=False)(_mutating(sgd_update_fn, 0))
sgd_mom_update = register("sgd_mom_update", wrap=False)(
    _mutating(sgd_mom_update_fn, 1))
nag_mom_update = register("nag_mom_update", wrap=False)(
    _mutating(nag_mom_update_fn, 1))
adam_update = register("adam_update", wrap=False)(
    _mutating(adam_update_fn, 2))
rmsprop_update = register("rmsprop_update", wrap=False)(
    _mutating(rmsprop_update_fn, 1))
rmspropalex_update = register("rmspropalex_update", wrap=False)(
    _mutating(rmspropalex_update_fn, 3))
ftrl_update = register("ftrl_update", wrap=False)(
    _mutating(ftrl_update_fn, 2))
adagrad_update = register("adagrad_update", wrap=False)(
    _mutating(adagrad_update_fn, 1))
signsgd_update = register("signsgd_update", wrap=False)(
    _mutating(signsgd_update_fn, 0))
signum_update = register("signum_update", wrap=False)(
    _mutating(signum_update_fn, 1))
