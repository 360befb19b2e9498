"""One host of an elastic fleet (counterpart of ``tools/fleet_worker.py``).

``python -m mxtpu_torch.fleet_worker --ckpt-dir DIR --coordinator
HOST:PORT --world N --rank R --fleet-dir DIR [...]``, the child a
``fleet.FleetSupervisor`` launches a host (``fleet.bootstrap_argv``
spells its bootstrap as these flags). It joins the fleet
(``fleet.init``), trains with ``gluon.Trainer(mesh=fleet.mesh(),
zero1=True)`` on its rows of each global batch, checkpoints through
``resilience.ResilientLoop`` (every rank calls the save: ZeRO-1's states
are gathered, and the first rank writes), and prints one ``RESULT`` JSON
line (and ``BRINGUP <s>``, ``RESTORE <s> start <step>``, ``EVAL <s>
<loss>``, as each step ends ``STEP <step> <loss> <s> <peak bytes> <B1
launches so far>`` and after the first ``BUILDS <json>``, the capture
sites' builds, so a host that dies leaves its numbers in its output):
the global batch's
loss each step, the step it started from, the
divergence checks, the compile counters (nvcc builds, autotune searches,
disk hits and drops by site, captures by site), the obs publications, the
straggler trips, the B1 launches and the timings.

Models, each a function of ``--seed`` (data, weights, batch order):

* ``--model mlp`` (default), the reference worker's: Dense(hidden, relu)
  then Dense(1) on 4 features, L2 loss, SGD momentum 0.9, lr 0.05, global
  batch 8 of 64 rows, 6 steps; float32. The CPU tests run it with
  ``--device cpu --backend gloo``.
* ``--model resnet50_v1``: ResNet-50 v1 (1000 classes, 224x224 NHWC,
  seeded He-normal weights), softmax cross-entropy, SGD momentum 0.9 with
  ``multi_precision`` under ``--dtype bfloat16``, hybridized (captured on
  the card), 2 x the global batch's rows of seeded images.

``--micro-batch M`` runs a host's rows as forward/backward passes of M
rows whose gradients add up (``grad_req="add"``), so that BatchNorm's
batch statistics stay per M rows whatever the world size: a restore
onto one host then continues the two-host trajectory.

Each step: ``host_loss@step`` may end the host; a heartbeat and membership
probe; ``straggler_slow@step`` stalls ``--straggler-s`` seconds, billed to
``data.wait``; the step runs armed under the collective watchdog (a wedge
exits 42 from its monitor); it opens with a gather of each host's ready
time, where a fast host waits for a slow one, so that wait stays out of
the stages the straggler sentinel compares; a collective that raises
ends in ``Fleet.collective_failed`` (exit 42 once the board names a dead
host). Then the fingerprint of the trainable weights, every host's own
stages and the arrival time go through ``Fleet.step_barrier``;
rank 0's ``StragglerSentinel`` reads them.

``--eval-rows K`` serves the restored (or initial) weights on K held-out
rows through a ``serving.Predictor`` before training (``restore_eval``
in the result): that capture site, too, starts warm from the disk cache
on a rejoin, on the CPU as well as on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

MLP_ROWS = 64


def _args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mxtpu_torch.fleet_worker")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--fleet-dir", default=None)
    ap.add_argument("--compile-cache-dir", default=None)
    ap.add_argument("--faults", default=None,
                    help="resilience.set_faults spec, e.g. host_loss@4")
    ap.add_argument("--model", default="mlp",
                    choices=("mlp", "resnet50_v1"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--micro-batch", type=int, default=0)
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--features", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--ckpt-keep", type=int, default=0)
    ap.add_argument("--collective-timeout", type=float, default=0.0)
    ap.add_argument("--heartbeat-s", type=float, default=2.0)
    ap.add_argument("--obs-s", type=float, default=0.0)
    ap.add_argument("--straggler-x", type=float, default=0.0)
    ap.add_argument("--straggler-s", type=float, default=0.35)
    ap.add_argument("--build-dir", default=None,
                    help="the kernels' build directory (an empty one: "
                    "every library from the cache dir or nvcc)")
    ap.add_argument("--eval-rows", type=int, default=0)
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms")
    return ap.parse_args(argv)


# ------------------------------------------------------------------ models
def mlp_data(seed, features):
    """(x [64, features], y [64, 1]) float32, the reference worker's."""
    import numpy as np
    rs = np.random.RandomState(seed)
    x = rs.randn(MLP_ROWS, features).astype("float32")
    w_true = rs.randn(features, 1).astype("float32")
    y = (x @ w_true + 0.1 * rs.randn(MLP_ROWS, 1)).astype("float32")
    return x, y


def mlp_weights(seed, features, hidden):
    """The MLP's weights in parameter order (weight, bias, weight, bias)."""
    import numpy as np
    r = np.random.RandomState(seed + 1000)
    return [r.uniform(-0.5, 0.5, s).astype(np.float32)
            for s in [(hidden, features), (hidden,), (1, hidden), (1,)]]


def _mlp(args):
    import mxtpu_torch as mt
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(args.hidden, activation="relu",
                              in_units=args.features))
    net.add(mt.gluon.nn.Dense(1, in_units=args.hidden))
    net.initialize()
    for p, w in zip(net.collect_params().values(),
                    mlp_weights(args.seed, args.features, args.hidden)):
        p.set_data(mt.nd.array(w))
    x, y = mlp_data(args.seed, args.features)
    opt = {"learning_rate": args.lr, "momentum": 0.9}
    return net, mt.gluon.loss.L2Loss(), mt.nd.array(x), mt.nd.array(y), opt


def resnet_data(seed, rows):
    """``rows`` seeded NHWC 224x224 images and labels in [0, 1000)."""
    import numpy as np
    rng = np.random.default_rng([seed, 224])
    x = rng.standard_normal((rows, 224, 224, 3), dtype=np.float32)
    y = rng.integers(0, 1000, rows).astype(np.float32)
    return x, y


def _resnet(args):
    import torch
    import mxtpu_torch as mt
    from mxtpu_torch import convert
    from mxtpu_torch.gluon.model_zoo import vision
    with mt.layout("NHWC"):
        net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=mt.cpu())
    with torch.no_grad():   # settle the deferred shapes at a small size
        net(torch.zeros(1, 32, 32, 3))
    convert.load_mxtpu_params(net, convert.seeded_params(
        {k: p.shape for k, p in net.collect_params().items()},
        seed=args.seed))
    if args.dtype != "float32":
        net.cast(args.dtype)
    net.collect_params().reset_ctx(mt.current_context())
    x, y = resnet_data(args.seed, 2 * args.batch)
    x = mt.nd.array(x).astype(args.dtype)
    opt = {"learning_rate": args.lr, "momentum": 0.9,
           "multi_precision": args.dtype != "float32"}
    return (net, mt.gluon.loss.SoftmaxCrossEntropyLoss(), x,
            mt.nd.array(y), opt)


# ---------------------------------------------------------------- counters
def compile_counts():
    """The compile phase's counters: nvcc builds, autotune searches and
    plan hits, disk hits/writes/drops by site or reason, captures by
    site."""
    from mxtpu_torch import kernels, telemetry
    return {"nvcc": kernels.nvcc_runs(),
            "searches": int(telemetry.value("autotune.searches")),
            "plan_hits": telemetry.tagged("autotune.plan_hits"),
            "disk_hits": telemetry.tagged("compile.disk.hits"),
            "disk_writes": telemetry.tagged("compile.disk.writes"),
            "disk_drops": telemetry.tagged("compile.disk.drops"),
            "captures": {s: st["compiles"] for s, st in
                         telemetry.retrace_stats().items()}}


def site_builds():
    """``{site: {entries, build_s, disk}}`` of the compile service's
    entries in this process: each site's captures, their seconds, and how
    many started from a disk blob."""
    from mxtpu_torch import compile_service
    out = {}
    for key, e in list(compile_service._STORE.items()):
        if not isinstance(e.record, dict):
            continue
        row = out.setdefault(key.site, {"entries": 0, "build_s": 0.0,
                                        "disk": 0})
        row["entries"] += 1
        row["build_s"] += e.record["build_s"]
        row["disk"] += e.origin == "disk"
    return out


def _peak(device):
    """Peak bytes allocated on the card so far (0 on the CPU)."""
    import torch
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def _restore_eval(net, loss_fn, x, y, rows, device):
    """The held-out loss of the current weights served through a
    Predictor (its capture site resolves through the compile service)."""
    from mxtpu_torch.serving import BucketSpec, Predictor
    n = x.shape[0]
    xe, ye = x[n - rows:], y[n - rows:]
    pred = Predictor(net, BucketSpec(batch_sizes=[rows]), device=device)
    out = pred.predict(xe)
    return float(loss_fn(out, ye).mean().asnumpy())


# -------------------------------------------------------------------- main
def main(argv=None):
    args = _args(argv)
    t_start = time.time()
    import numpy as np
    import torch
    from pathlib import Path
    from mxtpu_torch import kernels
    if args.build_dir:
        kernels.BUILD_DIR = Path(args.build_dir)
    import mxtpu_torch as mt
    from mxtpu_torch import (autograd, compile_service, distributed, fleet,
                             fleet_obs, resilience, telemetry, xprof)
    from mxtpu_torch.io.stream import shard_keys
    from mxtpu_torch.ops.pallas import autotune
    from mxtpu_torch.ops.pallas.conv import fused_conv

    resilience.set_faults(args.faults)
    resilience.set_ckpt_keep(args.ckpt_keep)
    if args.compile_cache_dir:
        compile_service.set_cache_dir(args.compile_cache_dir)
        autotune.set_enabled(True)   # plans served from the cache dir
    telemetry.set_flight_dir(args.fleet_dir)   # artifacts on the board
    device = torch.device(args.device)
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    t0 = time.time()
    f = fleet.init(fleet_dir=args.fleet_dir,
                   coordinator_address=args.coordinator,
                   num_processes=args.world, process_id=args.rank,
                   backend=args.backend,
                   collective_timeout_s=args.collective_timeout,
                   heartbeat_s=args.heartbeat_s)
    bringup_s = time.time() - t0
    print("BRINGUP %.3f" % bringup_s, flush=True)
    rank, world = f.rank, f.num_hosts
    mesh = f.mesh()
    pub = None
    if f.fleet_dir and args.obs_s > 0:
        pub = fleet_obs.HostObsPublisher(f.fleet_dir, rank,
                                         interval_s=args.obs_s).install()
    straggler = fleet_obs.StragglerSentinel(factor=args.straggler_x) \
        if rank == 0 else None
    regression = fleet_obs.RegressionSentinel(factor=args.straggler_x)

    ctx = mt.cpu() if device.type == "cpu" else mt.gpu(device.index or 0)
    with ctx:
        build = _mlp if args.model == "mlp" else _resnet
        net, loss_fn, x_all, y_all, opt = build(args)
        if args.model != "mlp":
            net.hybridize()
            loss_fn.hybridize()
        n_rows = x_all.shape[0]
        trainable = [p for p in net.collect_params().values()
                     if p.grad_req != "null"]
        for p in trainable:   # micro-batches add up; zeroed each step
            p.grad_req = "add"
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd", opt,
                                   mesh=mesh, zero1=True)
        # a host's own MFU each step, for the observatory's fleet.mfu
        trainer._mfu = xprof.MFUMeter(every=1, n_devices=1,
                                      device=device, dtype=args.dtype)
        loop = resilience.ResilientLoop(trainer, resilience.CheckpointPolicy(
            args.ckpt_dir, every_steps=args.save_every, async_save=False))
        t0 = time.time()
        start = loop.resume()
        restore_s = time.time() - t0
        print("RESTORE %.3f start %d" % (restore_s, start), flush=True)
        restore_eval = None
        if args.eval_rows:
            t0 = time.time()
            restore_eval = _restore_eval(net, loss_fn, x_all, y_all,
                                         args.eval_rows, device)
            print("EVAL %.3f %r" % (time.time() - t0, restore_eval),
                  flush=True)
        f.barrier("fleet_worker_resumed")
        wd = f.watchdog(exit_on_trip=True).start_monitor()
        local = args.batch // world
        micro = args.micro_batch or local
        if args.batch % world or local % micro:
            raise SystemExit("batch %d over %d hosts in micro-batches of %d"
                             % (args.batch, world, micro))
        losses, step_s, peer_wait = [], [], []
        step = start
        try:
            for step in range(start, args.steps):
                fleet.maybe_host_loss(step)
                f.check(step)
                ts = time.time()
                idx = [(step * args.batch + i) % n_rows
                       for i in range(args.batch)]
                parts = [shard_keys(idx, num_shards=world, shard_index=r,
                                    shuffle=False) for r in range(world)]
                assert [k for p in parts for k in p] == idx, \
                    "shard_keys shards no longer reassemble the global batch"
                xb, yb = trainer.shard_batch(x_all[np.array(idx)],
                                             y_all[np.array(idx)])
                slow_s = 0.0
                if resilience.inject("straggler_slow", step):
                    slow_s = args.straggler_s
                    time.sleep(slow_s)
                entry = wd.arm(step, what="train step")
                try:
                    t_ready = time.time()
                    if world > 1:   # a fast host waits for a slow one here
                        distributed.allgather_host(np.array([t_ready]))
                    peer_wait.append(time.time() - t_ready)
                    t_fb = time.time()
                    lsum = None
                    for p in trainable:
                        p.zero_grad()
                    for k in range(0, local, micro):
                        with autograd.record():
                            loss = loss_fn(net(xb[k:k + micro]),
                                           yb[k:k + micro])
                        loss.backward()
                        s = loss._data.detach().float().sum()
                        lsum = s if lsum is None else lsum + s
                    fb_s = time.time() - t_fb
                    trainer.step(local)
                    fp = fleet.replica_fingerprint(trainable)
                    lval = float(distributed.allreduce_host(np.array(
                        [float(lsum)]))[0]) / args.batch
                    stages = dict(trainer.last_step_stages or {})
                    stages["trainer.forward_backward"] = fb_s
                    if slow_s:
                        stages["data.wait"] = \
                            stages.get("data.wait", 0.0) + slow_s
                    obs = {"trace": trainer.last_step_trace,
                           "stages": stages}
                    fps = f.step_barrier(step, fingerprint=fp, obs=obs)
                    if straggler is not None and fps:
                        straggler.observe(step, fps)
                    regression.observe(step, sum(stages.values()) or None)
                    losses.append(lval)
                    step_s.append(time.time() - ts)
                    print("STEP %d %r %.4f %d %d" % (
                        step, lval, step_s[-1], _peak(device),
                        fused_conv.launches), flush=True)
                    if len(step_s) == 1:
                        print("BUILDS " + json.dumps(site_builds()),
                              flush=True)
                    if pub is not None:
                        pub.maybe_publish(step)
                    loop.after_step(step)   # every rank: ZeRO-1's gather
                except (fleet.FleetWedgeError, resilience.DivergenceError):
                    raise
                except Exception as e:   # a collective on a dead peer
                    err = f.collective_failed(step, e)
                    if err is None:
                        raise
                    raise err from e
                finally:
                    wd.disarm(entry)
        except fleet.FleetWedgeError as e:
            print("FLEET WEDGE rank %d step %d: %s" % (rank, step, e),
                  flush=True)
            os._exit(fleet.EXIT_FLEET_WEDGE)
        loop.wait_for_pending()
    if pub is not None:
        pub.publish()   # the finished run's registry
    timed = step_s[1:]
    rec = {"rank": rank, "world": world, "start": start,
           "steps": args.steps, "model": args.model, "dtype": args.dtype,
           "losses": losses,
           "divergence_checks": int(telemetry.value(
               "resilience.divergence_checks")),
           "wall_s": time.time() - t_start, "bringup_s": bringup_s,
           "restore_s": restore_s, "restore_eval": restore_eval,
           "first_step_s": step_s[0] if step_s else None,
           "step_s": step_s, "peer_wait_s": peer_wait,
           "steps_per_s": (len(timed) / sum(timed)) if timed else None,
           "peak_bytes": _peak(device),
           "b1_launches": fused_conv.launches,
           "obs_publishes": int(telemetry.value("fleet.obs.publishes")),
           "straggler_trips": sum(
               (telemetry.tagged("fleet.straggler_trips") or {}).values())}
    rec.update(compile_counts())
    if straggler is not None and straggler.trips:
        rec["straggler"] = straggler.trips[-1]["rank"]
        rec["straggler_stage"] = straggler.trips[-1]["dominant_stage"]
        rec["straggler_step"] = straggler.trips[-1]["step"]
    print("RESULT " + json.dumps(rec, default=str), flush=True)
    wd.stop_monitor()
    f.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
