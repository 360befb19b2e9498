"""Device rules of the port (mxtpu_torch): entry points run on the CUDA
device unless the caller passes a CPU device, with no CPU fallback; the
port imports nothing of JAX or of the JAX package; kernels are built from
csrc/ only when first used."""
import ast
import os

import numpy as np
import pytest
import torch

import mxtpu_torch as mt
from mxtpu_torch import context, kernels
from mxtpu_torch.gluon import nn
from mxtpu_torch.serving import BucketSpec, Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_cuda):
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.default_device()
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        context.resolve_device(None)


def test_predictor_without_device_raises_without_a_card(no_cuda):
    net = nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        Predictor(net, BucketSpec([2]))
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        nn.Dense(3, in_units=4).initialize()
    # an explicit CPU device is honoured
    out = Predictor(net, BucketSpec([2]), device="cpu").predict(
        np.ones((1, 4), np.float32))
    assert out.context.type == "cpu" and out.shape == (1, 3)


def test_device_names():
    assert mt.cpu() == torch.device("cpu")
    assert mt.gpu(1) == torch.device("cuda", 1)
    assert context.resolve_device("cuda") == torch.device("cuda", 0)
    assert context.resolve_device(mt.cpu()) == torch.device("cpu")


def test_deferred_parameters_follow_the_device():
    """An unsettled parameter records the device it is moved to and
    materializes there (here the CPU) in its dtype."""
    net = nn.Dense(3)
    net.initialize(ctx=mt.cpu())
    assert not net.weight.initialized
    net.cast("bfloat16")
    net.collect_params().reset_ctx("cpu")
    net(torch.zeros(2, 5, dtype=torch.bfloat16))
    w = net.weight.data().to_torch()
    assert w.shape == (3, 5) and w.dtype == torch.bfloat16
    assert dict(net.named_parameters())["weight"] is w


def _port_files():
    pkg = os.path.join(ROOT, "mxtpu_torch")
    files = [os.path.join(ROOT, n)
             for n in ("chip_smoke.py", "flash_ab.py", "conv_search.py",
                       "variant_search.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_and_no_mxtpu():
    banned = ("jax", "jaxlib", "mxtpu")
    seen = 0
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, (path, m)
            seen += 1
    assert seen > 20


def test_import_scan_covers_the_input_path():
    """The scans above walk every module of the input slice."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("recordio.py", "io/io.py", "io/stream.py",
                "gluon/data/dataloader.py", "gluon/data/_mp_worker.py",
                "gluon/data/sampler.py", "gluon/data/dataset.py",
                "gluon/data/vision/transforms.py",
                "gluon/data/vision/datasets.py", "ops/image_ops.py",
                "ndarray/image.py", "ndarray/sparse.py", "image/image.py",
                "image/detection.py"):
        assert os.path.join("mxtpu_torch", rel) in scanned, rel


def test_port_reads_no_environment_variable_of_its_own():
    """The port takes its levers as arguments and setters; the only
    variables it reads are the CUDA toolkit's location (kernels.py)."""
    import re
    seen = {}
    for path in _port_files():
        src = open(path).read()
        for m in re.finditer(r"environ(?:\.get)?\(?\[?\s*[\"']([A-Z_]+)"
                             r"|getenv\(\s*[\"']([A-Z_]+)", src):
            seen.setdefault(m.group(1) or m.group(2), set()).add(
                os.path.relpath(path, ROOT))
    assert seen == {"CUDA_HOME": {"mxtpu_torch/kernels.py"},
                    "CUDA_PATH": {"mxtpu_torch/kernels.py"}}, seen


def test_kernel_library_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    """Libraries are named by a hash of csrc/ and the nvcc flags; nothing is
    built until a kernel is first launched."""
    assert kernels.sources() == ["flash_attention", "fused_conv"]
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    so1, _ = kernels._target("k")
    assert so1.parent == tmp_path / "build" and not so1.exists()
    (src / "k.cu").write_text("// v2\n")
    so2, _ = kernels._target("k")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    so3, _ = kernels._target("k")
    assert len({so1, so2, so3}) == 3
    assert all("sm_90a" in f for f in kernels.NVCC_FLAGS
               if f.startswith("arch="))


def test_import_scan_covers_the_symbolic_api():
    """The scans above walk every module of the symbolic slice."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("name.py", "attribute.py", "symbol/__init__.py",
                "symbol/symbol.py", "symbol/executor.py",
                "symbol/subgraph.py", "executor.py", "executor_manager.py",
                "ops/subgraph_ops.py", "model.py", "callback.py",
                "monitor.py", "module/__init__.py", "module/base_module.py",
                "module/module.py", "module/bucketing_module.py",
                "module/sequential_module.py", "module/python_module.py"):
        assert os.path.join("mxtpu_torch", rel) in scanned, rel


def test_symbolic_entry_points_default_to_the_card(no_cuda, tmp_path):
    """An Executor, a Module and Predictor.from_checkpoint run on cuda:0
    unless given the CPU, and raise without a card."""
    data = mt.sym.var("data")
    sym = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(data, num_hidden=3,
                                                     name="fc"),
                               name="softmax")
    shapes = {"data": (2, 4), "softmax_label": (2,)}
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        sym.simple_bind(**shapes)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        sym.simple_bind(mt.gpu(0), **shapes)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.mod.Module(sym)
    exe = sym.simple_bind(mt.cpu(), **shapes)
    assert exe.arg_dict["fc_weight"].context == torch.device("cpu")
    mod = mt.mod.Module(sym, context=mt.cpu())
    mod.bind(data_shapes=[("data", (2, 4))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params(initializer=mt.init.Xavier())
    mod.save_checkpoint(str(tmp_path / "m"), 1)
    inputs = ("data", "softmax_label")
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        Predictor.from_checkpoint(str(tmp_path / "m"), 1, BucketSpec([2]),
                                  input_names=inputs)
    pred = Predictor.from_checkpoint(str(tmp_path / "m"), 1, BucketSpec([2]),
                                     input_names=inputs, device="cpu")
    out = pred.predict(np.ones((2, 4), np.float32),
                       np.zeros(2, np.float32))
    assert out.context.type == "cpu" and out.shape == (2, 3)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.gluon.SymbolBlock.imports(str(tmp_path / "m-symbol.json"),
                                     ["data", "softmax_label"],
                                     str(tmp_path / "m-0001.params"))


def test_import_scan_covers_the_rnn_slice():
    """The scans above walk every module of the RNN slice."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("ops/rnn_ops.py", "ops/ctc.py", "ops/control_flow.py",
                "gluon/rnn/__init__.py", "gluon/rnn/rnn_cell.py",
                "gluon/rnn/rnn_layer.py", "gluon/contrib/__init__.py",
                "gluon/contrib/nn/__init__.py",
                "gluon/contrib/rnn/__init__.py",
                "gluon/contrib/rnn/rnn_cell.py",
                "gluon/contrib/rnn/conv_rnn_cell.py", "rnn/__init__.py",
                "rnn/rnn_cell.py", "rnn/rnn.py", "rnn/io.py"):
        assert os.path.join("mxtpu_torch", rel) in scanned, rel


def test_rnn_entry_points_default_to_the_card(no_cuda):
    """The RNN layers and cells, their begin states, the symbolic cells'
    executor, the sentence iterator and a fused cell's unpacked weights
    are on cuda:0 unless given the CPU, and raise without a card."""
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.gluon.rnn.LSTM(4, input_size=3).initialize()
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.gluon.rnn.LSTMCell(4, input_size=3).initialize()
    layer = mt.gluon.rnn.GRU(4, input_size=3)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        layer.begin_state(batch_size=2)
    layer.initialize(ctx=mt.cpu())
    out = layer(torch.zeros(5, 2, 3))   # states follow the input's device
    assert out.device.type == "cpu" and out.shape == (5, 2, 4)
    with mt.cpu():
        assert layer.begin_state(batch_size=2)[0].context.type == "cpu"
    cell = mt.rnn.LSTMCell(4, prefix="l_")
    sym, _ = cell.unroll(3, mt.sym.var("data"),
                         begin_state=cell.begin_state(batch_size=2))
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        mt.sym.Group(sym).simple_bind(data=(2, 3, 5))
    exe = mt.sym.Group(sym).simple_bind(mt.cpu(), data=(2, 3, 5))
    assert exe.forward()[0].context.type == "cpu"
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        list(mt.rnn.BucketSentenceIter([[1, 2, 3]] * 4, 2, buckets=[3]))
    fused = mt.rnn.FusedRNNCell(4, prefix="f_")
    blob = np.zeros(mt.ops.rnn_ops.rnn_param_size("lstm", 1, 3, 4),
                    np.float32)
    with pytest.raises(mt.MXNetError, match="no CUDA device"):
        fused.unpack_weights({"f_parameters": blob})
