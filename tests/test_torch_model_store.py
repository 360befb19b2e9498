"""The port's pretrained-weight store, mirroring tests/test_model_store.py:
local files only, the search path given as ``root`` (the port reads no
environment variable where the reference reads
``$MXTPU_MODEL_ZOO_PATH``), the reference's names and sha1 table, and
``pretrained=True, root=...`` in every zoo constructor loading through
``load_parameters``, here from a file ``mxtpu`` saved, to the logits of
the net that saved it (float32 rtol=atol=1e-5 of max|logit|)."""
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu.gluon.model_zoo import model_store as jstore
from mxtpu.gluon.model_zoo import vision as jvision
import mxtpu_torch as mt
from mxtpu_torch import convert
from mxtpu_torch.base import MXNetError
from mxtpu_torch.gluon.model_zoo import model_store
from mxtpu_torch.gluon.model_zoo import vision


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("MXTPU_MODEL_ZOO_PATH", raising=False)


def test_sha1_table_and_short_hash_equal_the_reference():
    assert model_store._model_sha1 == jstore._model_sha1
    for name in ("resnet50_v1", "mobilenetv2_0.25", "inceptionv3"):
        assert model_store.short_hash(name) == jstore.short_hash(name)
    with pytest.raises(MXNetError, match="not available"):
        model_store.short_hash("resnet19_v9")


def test_get_model_file_plain_dropin(tmp_path):
    f = tmp_path / "resnet18_v1.params"
    f.write_bytes(b"x")
    assert model_store.get_model_file("resnet18_v1",
                                      root=str(tmp_path)) == str(f)
    # a list of roots is searched in order
    other = tmp_path / "other"
    other.mkdir()
    assert model_store.get_model_file(
        "resnet18_v1", root=[str(other), str(tmp_path)]) == str(f)


def test_get_model_file_verified_name(tmp_path, monkeypatch):
    blob = b"weights"
    import hashlib
    digest = hashlib.sha1(blob).hexdigest()
    monkeypatch.setitem(model_store._model_sha1, "alexnet", digest)
    f = tmp_path / ("alexnet-%s.params" % digest[:8])
    f.write_bytes(blob)
    assert model_store.get_model_file("alexnet", root=str(tmp_path)) == str(f)


def test_get_model_file_missing_raises_with_instructions(tmp_path):
    with pytest.raises(MXNetError, match="root="):
        model_store.get_model_file("resnet18_v1", root=str(tmp_path))


def test_get_model_file_rejects_bad_hash(tmp_path):
    bad = tmp_path / ("resnet18_v1-%s.params"
                      % model_store.short_hash("resnet18_v1"))
    bad.write_bytes(b"junk")
    with pytest.raises(MXNetError):
        model_store.get_model_file("resnet18_v1", root=str(tmp_path))


def test_purge(tmp_path):
    (tmp_path / "resnet18_v1.params").write_bytes(b"x")
    (tmp_path / "keep.txt").write_bytes(b"x")
    model_store.purge(root=str(tmp_path))
    assert not (tmp_path / "resnet18_v1.params").exists()
    assert (tmp_path / "keep.txt").exists()


@pytest.mark.parametrize("name,file_name", [
    ("resnet18_v2", "resnet18_v2"), ("mobilenet0.25", "mobilenet0_25"),
    ("mobilenet_v2_0_25", "mobilenetv2_0_25"),
    ("squeezenet1.1", "squeezenet1_1")])
def test_pretrained_loads_an_mxtpu_file_from_root(tmp_path, name, file_name):
    x = np.random.RandomState(0).uniform(-1, 1, (1, 3, 64, 64))
    x = x.astype(np.float32)
    shaped = vision.get_model(name, classes=10)   # settles the shapes
    shaped.initialize(ctx=mt.cpu())
    with torch.no_grad():
        shaped(torch.from_numpy(x))
    arrays = {k.partition("_")[2]: a for k, a in convert.seeded_params(
        {k: p.shape for k, p in shaped.collect_params().items()},
        seed=1).items()}
    src = jvision.get_model(name, classes=10)
    for k, p in src.collect_params().items():
        p.set_data(mx.nd.array(arrays[k.partition("_")[2]]))
    src.hybridize()
    src.save_parameters(str(tmp_path / (file_name + ".params")))
    ref = src(mx.nd.array(x)).asnumpy()
    net = vision.get_model(name, classes=10, pretrained=True,
                           root=str(tmp_path), ctx=mt.cpu())
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_pretrained_without_a_file_raises(tmp_path):
    with pytest.raises(MXNetError, match="not found"):
        vision.alexnet(pretrained=True, root=str(tmp_path), ctx=mt.cpu())
