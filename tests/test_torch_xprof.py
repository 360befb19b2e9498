"""``xprof`` and ``perf_model`` of the port, on the CPU: the ledger's
FLOPs of a measured run against an analytic count (a matmul, a
convolution through the fused conv's plain version, a kernel wrapper's
reported FLOPs), executed FLOPs and ``MFUMeter`` under a set peak, the
memory gauges from injected stats held to the JAX package's, ``is_oom``
and ``oom_flight``'s artifact, the peak table and the roofline."""
import json

import numpy as np
import pytest
import torch

from mxtpu import perf_model as jpm
from mxtpu import telemetry as jtel
from mxtpu import xprof as jxprof
import mxtpu_torch as mt
from mxtpu_torch import perf_model as tpm
from mxtpu_torch import resilience as tres
from mxtpu_torch import telemetry as ttel
from mxtpu_torch import xprof as txprof
from mxtpu_torch.ops.pallas import conv as tconv


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.delenv("MXTPU_PEAK_TFLOPS", raising=False)
    for tel in (jtel, ttel):
        tel.reset()
    yield
    tpm.set_peak(None)
    txprof.set_enabled(True)
    ttel.set_flight_dir(None)
    ttel.reset()


def test_measured_flops_against_analytic_counts():
    a, b = torch.randn(16, 32), torch.randn(32, 8)
    with txprof.measuring() as m:
        torch.matmul(a, b)
    assert m["flops"] == 2 * 16 * 32 * 8
    # the fused conv's plain version on the CPU: its FLOPs through the
    # counter; a kernel launch reports its own through add_flops
    x, w = torch.randn(2, 9, 9, 4), torch.randn(3, 3, 4, 6)
    with txprof.measuring() as m:
        tconv.fused_conv(x, w, padding=((1, 1), (1, 1)))
    assert m["flops"] == 2 * 2 * 9 * 9 * 6 * 3 * 3 * 4
    with txprof.measuring() as m:
        txprof.add_flops(1e6)
        with txprof.measuring() as inner:   # nested: the outer counts
            txprof.add_flops(5.0)
    assert m["flops"] == 1e6 + 5.0 and inner["flops"] == 5.0
    txprof.add_flops(7.0)   # nothing measuring: dropped


def test_ledger_executed_flops_and_mfu_meter():
    e = txprof.attach("cached_op", {"block": "Dense"}, flops=1e9,
                      compile_s=0.5)
    txprof.watch("cached_op.backward", flops=2e9)
    txprof.attach("serving.predict.r0", flops=4e9)
    for _ in range(3):
        txprof.called(e)
    led = txprof.ledger()
    assert [x["site"] for x in led] == ["cached_op", "cached_op.backward",
                                        "serving.predict.r0"]
    assert led[0]["calls"] == 3 and led[0]["compile_s"] == 0.5
    assert txprof.executed_flops(["cached_op"]) == 3e9
    assert txprof.executed_flops(["serving.predict"]) == 0.0
    assert txprof.summary()["compiles"] == 3
    # the meter: no peak on the CPU, no gauge; with a set peak, the window
    meter = txprof.MFUMeter(every=2, dtype="float32")
    assert meter.step() is None and meter.step() is None
    tpm.set_peak(tflops=1e-3)   # 1 GFLOP/s
    meter = txprof.MFUMeter(every=1, dtype="float32")
    meter.step()
    txprof.called(e, 5)          # 5 GFLOP more
    import time
    time.sleep(0.05)
    mfu = meter.step()
    assert mfu is not None and 0 < mfu < 5e9 / 1e9 / 0.05
    assert ttel.gauge_value("perf.mfu") == mfu
    txprof.set_enabled(False)
    assert txprof.attach("x", flops=1.0) is None
    assert txprof.MFUMeter().step() is None


def test_memory_gauges_like_mxtpu():
    stats = {"d0": {"bytes_in_use": 100, "bytes_limit": 1000,
                    "peak_bytes_in_use": 300}}
    txprof.poll_memory(stats)
    jxprof.poll_memory(stats)
    for g in ("memory.hbm_used_bytes", "memory.hbm_limit_bytes",
              "memory.hbm_headroom_bytes", "memory.hbm_peak_bytes"):
        assert ttel.gauge_value(g, "d0") == jtel.gauge_value(g, "d0")
    assert txprof.poll_memory() == {}   # no card
    assert txprof.ensure_memwatch() is False
    txprof.set_memwatch_interval(0.01)
    try:
        assert txprof.ensure_memwatch() is True
    finally:
        txprof.set_memwatch_interval(0)
        txprof.stop_memwatch()


@pytest.mark.parametrize("exc", [
    RuntimeError("RESOURCE_EXHAUSTED: out of HBM"),
    RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
    ValueError("shape mismatch"), None])
def test_is_oom_like_mxtpu(exc):
    assert txprof.is_oom(exc) == jxprof.is_oom(exc)


def test_oom_flight_and_the_trainer_path(tmp_path):
    ttel.set_flight_dir(str(tmp_path))
    assert txprof.is_oom(torch.cuda.OutOfMemoryError("x"))
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    tres.set_faults("oom@0")
    try:
        with mt.autograd.record():
            loss = net(mt.nd.array(np.ones((1, 3), np.float32),
                                   ctx=mt.cpu())).sum()
        loss.backward()
        with pytest.raises(tres.ResourceExhausted):
            tr.step(1)
    finally:
        tres.reset_faults()
    (art,) = tmp_path.glob("flight_oom_*")
    rec = json.loads(art.read_text())
    assert rec["extra"]["where"] == "trainer.step"
    assert "RESOURCE_EXHAUSTED" in rec["extra"]["error"]
    assert ttel.tagged("memory.oom") == {"trainer.step": 1}


def test_perf_model_table_and_roofline():
    assert tpm.nominal_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tpm.nominal_tflops("NVIDIA H100 80GB HBM3", "float32") == 67.0
    assert tpm.peak_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12
    assert tpm.peak_flops("cpu") is None and tpm.peak_bandwidth("cpu") is None
    assert tpm.nominal_tflops("NVIDIA A100") is None
    assert tpm.peak_flops("cpu", peak_tflops=2.0) == 2e12
    tpm.set_peak(tflops=3.0, gbps=1.0)
    assert tpm.peak_flops("cpu") == 3e12
    assert tpm.critical_intensity("cpu") == 3e12 / 1e9
    assert tpm.mfu(1.5e12, "cpu") == 0.5
    assert tpm.mfu(1.5e12, "cpu", n_devices=3) == 0.5 / 3
    for f, by, ridge in ((1e9, 1e8, 295.0), (1e9, 1e6, 295.0),
                         (None, 1.0, 1.0), (1.0, 1.0, None)):
        assert tpm.roofline_verdict(f, by, ridge) == \
            jpm.roofline_verdict(f, by, ridge)
    assert tpm.cost_dict([{"flops": 3.0}]) == jpm.cost_dict([{"flops": 3.0}])
    assert tpm.flops_of({"flops": -1}) is None
    assert tpm.flops_of({"flops": 8}) == 8.0
    assert tpm.bytes_accessed_of({"bytes accessed": 4}) == 4.0
    assert tpm.memory_dict({}) == {}
    assert tpm.memory_dict({"allocated_bytes.all.current": 5,
                            "num_ooms": 1}) == {"bytes_in_use": 5,
                                                "ooms": 1}
