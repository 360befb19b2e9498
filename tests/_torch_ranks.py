"""Spawns the port's ranks for the multi-device tests: ``run(fn, world,
tmp)`` starts ``world`` processes over a gloo ``file://`` rendezvous under
``tmp``, calls ``fn(rank, world, out_dir)`` in each (CPU only, the JAX
package never imported) and returns each rank's saved numpy arrays
(``save(out_dir, rank, **arrays)``). A rank that raises fails the run with
its traceback; every join has a timeout."""
import os
import pickle
import traceback

import numpy as np

JOIN_TIMEOUT_S = 240


def save(out_dir, rank, **arrays):
    path = os.path.join(out_dir, "rank%d.pkl" % rank)
    old = {}
    if os.path.exists(path):
        with open(path, "rb") as f:
            old = pickle.load(f)
    old.update({k: (np.asarray(v) if not isinstance(v, (str, bytes))
                    else v) for k, v in arrays.items()})
    with open(path, "wb") as f:
        pickle.dump(old, f)


def _entry(rank, fn, world, out_dir):
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch as mt
    try:
        mt.distributed.init("file://" + os.path.join(out_dir, "rdv"),
                            num_processes=world, process_id=rank,
                            backend="gloo", timeout=JOIN_TIMEOUT_S)
        with mt.cpu():
            fn(rank, world, out_dir)
        mt.distributed.barrier()
    except BaseException:
        with open(os.path.join(out_dir, "error%d.txt" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        mt.distributed.shutdown()


def run(fn, world, tmp):
    import torch.multiprocessing as mp
    out_dir = str(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, fn, world, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = []
    for r in range(world):
        path = os.path.join(out_dir, "error%d.txt" % r)
        if os.path.exists(path):
            with open(path) as f:
                errors.append("rank %d:\n%s" % (r, f.read()))
    if errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError("ranks failed (exit codes %s)\n%s"
                             % ([p.exitcode for p in procs],
                                "\n".join(errors)))
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, "rank%d.pkl" % r), "rb") as f:
            out.append(pickle.load(f))
    return out
