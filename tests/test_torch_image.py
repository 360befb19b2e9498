"""The image path of the port held to ``mxtpu``'s: the 13 ``_image_*`` ops
through ``mx.nd.image`` (crops and flips exact; to_tensor, normalize,
resize in its three interpolations, brightness, contrast, saturation and
hue within 1e-6 of max(1, max|ref|)); the random flips (one Bernoulli a
call from the port's generator: moments and whole-array flips, as
Dropout's draws are tested); the Gluon transforms, with the reference's
host draws under one Python ``random``/``np.random`` seed; the
``mx.image`` augmenters and ``CreateAugmenter`` on numpy images; the
detection augmenters; ``ImageIter``/``ImageDetIter`` over raw records (both
packages' decode patched to read raw pixels, so no cv2); and
``imdecode``/``imresize`` where cv2 is installed."""
import random

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu import recordio as jrec
from mxtpu_torch import recordio as trec
from mxtpu_torch.base import MXNetError

TOL = 1e-6
jT = mx.gluon.data.vision.transforms
tT = mt.gluon.data.vision.transforms


def _img(shape=(7, 9, 3), seed=0, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, shape).astype(dtype)


def _host(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _close(got, ref, exact=False):
    got, ref = _host(got), _host(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, \
        (got.shape, ref.shape, got.dtype, ref.dtype)
    if exact:
        np.testing.assert_array_equal(got, ref)
        return
    err = np.abs(got.astype(np.float64) - ref).max() if got.size else 0.0
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), err


def _both(name, data, **kw):
    ref = getattr(mx.nd.image, name)(mx.nd.array(data), **kw)
    got = getattr(mt.nd.image, name)(mt.nd.array(data, ctx=mt.cpu()), **kw)
    return got, ref


@pytest.mark.parametrize("shape", [(7, 9, 3), (2, 7, 9, 3)])
def test_exact_ops(shape):
    x = _img(shape)
    for name, kw in (("crop", dict(x=2, y=1, width=5, height=4)),
                     ("center_crop", dict(size=(4, 5))),
                     ("center_crop", dict(size=3)),
                     ("flip_left_right", {}), ("flip_top_bottom", {})):
        _close(*_both(name, x, **kw), exact=True)


@pytest.mark.parametrize("shape", [(7, 9, 3), (2, 7, 9, 3)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_value_ops_within_1e6(shape, dtype):
    x = _img(shape, seed=1, dtype=dtype)
    _close(*_both("to_tensor", x))
    chw = np.random.RandomState(2).rand(*((3, 5, 4) if len(shape) == 3
                                          else (2, 3, 5, 4))) \
        .astype(np.float32)
    _close(*_both("normalize", chw, mean=(0.4, 0.5, 0.6),
                  std=(0.2, 0.3, 0.25)))
    _close(*_both("normalize", chw, mean=0.5, std=2.0))
    for alpha in (0.3, 1.7):
        for name in ("brightness", "contrast", "saturation"):
            _close(*_both(name, x, alpha=alpha))
    for alpha in (-0.4, 0.0, 0.25):
        _close(*_both("hue", x, alpha=alpha))


@pytest.mark.parametrize("size", [(5, 4), (13, 11), (9, 7), (9, 3), 6])
@pytest.mark.parametrize("interp", [0, 1, 2])
def test_resize_matches_jax_image_resize(size, interp):
    x = np.random.RandomState(3).rand(2, 7, 9, 3).astype(np.float32) * 255
    _close(*_both("resize", x, size=size, interp=interp))
    _close(*_both("resize", x[0], size=size, interp=interp))


def test_resize_of_uint8_truncates_like_the_reference():
    x = _img((8, 8, 3), seed=4)
    got, ref = _both("resize", x, size=(4, 4), interp=1)
    assert got.dtype == ref.dtype == np.uint8
    # float results that land within rounding of an integer may truncate
    # to either side: at most one level, on few pixels
    diff = np.abs(_host(got).astype(int) - _host(ref).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    _close(*_both("resize", x, size=(16, 16), interp=0), exact=True)


def test_random_flips_draw_whole_array_flips_from_the_port_generator():
    x = mt.nd.array(_img((2, 4, 6, 3)), ctx=mt.cpu())
    xs = x.asnumpy()
    mt.random.seed(0, ctx=mt.cpu())
    for name, axis in (("random_flip_left_right", 2),
                       ("random_flip_top_bottom", 1)):
        flips = 0
        for _ in range(400):
            out = getattr(mt.nd.image, name)(x).asnumpy()
            flipped = np.array_equal(out, np.flip(xs, axis))
            assert flipped or np.array_equal(out, xs)
            flips += flipped
        assert 160 <= flips <= 240, flips   # p = 0.5, 400 draws: ~5 sigma
    out = mt.nd.image.random_flip_left_right(x, p=0.0).asnumpy()
    np.testing.assert_array_equal(out, xs)
    out = mt.nd.image.random_flip_top_bottom(x, p=1.0).asnumpy()
    np.testing.assert_array_equal(out, np.flip(xs, 1))
    mt.random.seed(5, ctx=mt.cpu())
    a = [mt.nd.image.random_flip_left_right(x).asnumpy() for _ in range(8)]
    mt.random.seed(5, ctx=mt.cpu())
    b = [mt.nd.image.random_flip_left_right(x).asnumpy() for _ in range(8)]
    assert all(np.array_equal(p, q) for p, q in zip(a, b))


def test_registry_holds_the_13_ops():
    names = {op.name for op in mt.ops.registry.REGISTRY.values()}
    ref = {op.name for op in mx.ops.registry.REGISTRY.values()}
    image = {n for n in ref if n.startswith("_image_")}
    assert len(image) == 13 and image <= names
    # 162 after the input slice; the symbolic slice added Flatten,
    # SoftmaxOutput, _subgraph_exec and _sg_flash_attention, the RNN
    # slice SliceChannel, the three Sequence* ops, RNN, CTCLoss, foreach,
    # while_loop and cond, the multi-device slice _contrib_ring_attention, its
    # second part _contrib_switch_moe; A10.1 and A10.2 added 57, A10.3 the
    # six sparse ops
    assert len(names & ref) == 240


def _transforms_pair(build, x, seed=9, exact=False):
    random.seed(seed)
    np.random.seed(seed)
    ref = build(jT)(mx.nd.array(x))
    random.seed(seed)
    np.random.seed(seed)
    got = build(tT)(mt.nd.array(x, ctx=mt.cpu()))
    _close(got, ref, exact=exact)


@pytest.mark.parametrize("build", [
    lambda T: T.Compose([T.ToTensor(), T.Normalize((0.4, 0.5, 0.6),
                                                   (0.2, 0.3, 0.25))]),
    lambda T: T.Cast("float16"),
    lambda T: T.Resize((5, 4)),
    lambda T: T.Resize(6, keep_ratio=True),
    lambda T: T.CenterCrop(5),
    lambda T: T.CenterCrop((12, 3)),
    lambda T: T.RandomResizedCrop(4),
    lambda T: T.RandomBrightness(0.5),
    lambda T: T.RandomContrast(0.5),
    lambda T: T.RandomSaturation(0.5),
    lambda T: T.RandomHue(0.3),
    lambda T: T.RandomColorJitter(0.4, 0.4, 0.4, 0.2),
    lambda T: T.Compose([T.Cast(), T.RandomLighting(0.1)]),
])
def test_transforms_match_the_reference(build):
    _transforms_pair(build, _img((7, 9, 3), seed=5).astype(np.float32))


def test_transforms_on_tensors_and_uint8():
    x = _img((7, 9, 3), seed=6)
    _transforms_pair(lambda T: T.Compose([T.CenterCrop(5), T.ToTensor()]),
                     x)
    t = torch.from_numpy(x)
    out = tT.Compose([tT.ToTensor(), tT.Normalize(0.5, 0.25)])(t)
    assert isinstance(out, torch.Tensor) and out.shape == (3, 7, 9)
    ref = jT.Compose([jT.ToTensor(), jT.Normalize(0.5, 0.25)])(
        mx.nd.array(x))
    _close(out.numpy(), ref)


def _aug_pair(build, x, seed=3):
    random.seed(seed)
    ref = build(mx.image)(x)
    random.seed(seed)
    with mt.cpu():
        got = build(mt.image)(x)
    _close(got, ref, exact=True)


@pytest.mark.parametrize("build", [
    lambda I: I.RandomCropAug((5, 4)),
    lambda I: I.CenterCropAug((6, 3)),
    lambda I: I.HorizontalFlipAug(0.5),
    lambda I: I.CastAug(),
    lambda I: I.ColorNormalizeAug((120.0, 110.0, 100.0), (50.0, 60.0, 70.0)),
    lambda I: I.BrightnessJitterAug(0.3),
    lambda I: I.ContrastJitterAug(0.3),
    lambda I: I.SaturationJitterAug(0.3),
])
def test_augmenters_on_numpy_images(build):
    for seed in range(3):
        _aug_pair(build, _img((8, 7, 3), seed=seed).astype(np.float32),
                  seed)


def test_create_augmenter_chain_and_helpers():
    x = _img((9, 8, 3), seed=7)
    kw = dict(data_shape=(3, 5, 6), rand_crop=True, rand_mirror=True,
              mean=True, std=True, brightness=0.2, contrast=0.2,
              saturation=0.2)

    def chain(I):
        def run(im):
            for aug in I.CreateAugmenter(**kw):
                im = aug(im)
            return im
        return run

    _aug_pair(chain, x)
    _aug_pair(lambda I: (lambda im: I.fixed_crop(im, 1, 2, 4, 5)), x)
    _aug_pair(lambda I: (lambda im: I.random_crop(im, (4, 3))[0]), x)
    _aug_pair(lambda I: (lambda im: I.center_crop(im, (4, 3))[0]), x)
    _aug_pair(lambda I: (lambda im: I.color_normalize(
        im, np.array([1.0, 2.0, 3.0]), np.array([2.0, 2.0, 4.0]))), x)


def _det_label():
    return np.array([[0, 0.1, 0.2, 0.5, 0.6], [1, 0.4, 0.3, 0.9, 0.8],
                     [-1, -1, -1, -1, -1]], np.float32)


@pytest.mark.parametrize("build", [
    lambda D, I: D.DetHorizontalFlipAug(0.5),
    lambda D, I: D.DetRandomCropAug(min_crop_scale=0.5, p=1.0),
    lambda D, I: D.DetBorrowAug(I.CastAug()),
])
def test_detection_augmenters(build):
    import mxtpu.image.detection as jd
    import mxtpu_torch.image.detection as td
    for seed in range(4):
        x = _img((10, 12, 3), seed=seed)
        random.seed(seed)
        ri, rl = build(jd, mx.image)(x, _det_label())
        random.seed(seed)
        with mt.cpu():
            ti, tl = build(td, mt.image)(x, _det_label())
        _close(ti, ri, exact=True)
        np.testing.assert_array_equal(tl, rl)


def _raw_decode(self, blob):
    header, payload = self._rec_module.unpack(blob)
    img = np.frombuffer(payload, np.uint8).reshape(8, 8, 3)
    return np.asarray(header.label, np.float32).reshape(-1), img


@pytest.fixture
def raw_decode(monkeypatch):
    import mxtpu.image.image as jimg
    import mxtpu_torch.image.image as timg
    for mod, recmod in ((jimg, jrec), (timg, trec)):
        monkeypatch.setattr(mod.ImageIter, "_rec_module", recmod,
                            raising=False)
        monkeypatch.setattr(mod.ImageIter, "_decode_blob", _raw_decode)


def _records(tmp_path, labels):
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    rng = np.random.RandomState(4)
    w = trec.MXIndexedRecordIO(idx, rec, "w")
    for i, lab in enumerate(labels):
        w.write_idx(i, trec.pack(trec.IRHeader(0, lab, i, 0),
                                 rng.randint(0, 256, (8, 8, 3))
                                 .astype(np.uint8).tobytes()))
    w.close()
    return rec, idx


def _iter_pair(make, seed=13):
    out = []
    for pkg, scope in ((mx, None), (mt, mt.cpu())):
        random.seed(seed)
        it = make(pkg)
        if scope is None:
            batches = [b for b in it]
        else:
            with scope:
                batches = [b for b in it]
        out.append([([_host(d) for d in b.data],
                     [_host(lab) for lab in b.label], b.pad)
                    for b in batches])
    (got, ref) = out[1], out[0]
    assert len(got) == len(ref)
    for (gd, gl, gp), (rd, rl, rp) in zip(got, ref):
        assert gp == rp
        for a, b in zip(gd + gl, rd + rl):
            np.testing.assert_array_equal(a, b)


def test_image_iter_over_raw_records(tmp_path, raw_decode):
    rec, idx = _records(tmp_path, [float(i % 5) for i in range(11)])
    _iter_pair(lambda pkg: pkg.image.ImageIter(
        batch_size=4, data_shape=(3, 6, 5), path_imgrec=rec,
        path_imgidx=idx, shuffle=True, rand_crop=True, rand_mirror=True,
        mean=True, std=True, num_parts=2, part_index=1))
    with pytest.raises(MXNetError, match="unknown options"):
        mt.image.ImageIter(4, (3, 6, 5), path_imgrec=rec, bogus=1)


def test_image_det_iter_over_raw_records(tmp_path, raw_decode):
    labs = []
    for i in range(7):
        objs = [[i % 3, 0.1, 0.1, 0.6, 0.7], [1, 0.3, 0.2, 0.9, 0.9]][:1 + i % 2]
        labs.append(np.concatenate([[2, 5], np.ravel(objs)]))
    rec, idx = _records(tmp_path, labs)

    def make(pkg):
        return pkg.image.ImageDetIter(
            batch_size=3, data_shape=(3, 6, 6), path_imgrec=rec,
            path_imgidx=idx, rand_crop=0.5, rand_mirror=True,
            mean=True, std=True)

    pytest.importorskip("cv2")   # the detection chain's resize is cv2's
    _iter_pair(make)


def test_cv2_paths():
    cv2 = pytest.importorskip("cv2")
    x = _img((6, 7, 3), seed=8)
    ok, buf = cv2.imencode(".png", x)
    ref = mx.image.imdecode(buf.tobytes())
    with mt.cpu():
        got = mt.image.imdecode(buf.tobytes())
        _close(got, ref, exact=True)
        _close(mt.image.imresize(x, 4, 3), mx.image.imresize(x, 4, 3),
               exact=True)
        _close(mt.image.resize_short(x, 4), mx.image.resize_short(x, 4),
               exact=True)


def test_cv2_paths_raise_naming_cv2_when_it_is_missing(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(MXNetError, match="cv2"):
        mt.image.imdecode(b"\x89PNG")
    with pytest.raises(MXNetError, match="cv2"):
        mt.image.imresize(_img(), 4, 4)
