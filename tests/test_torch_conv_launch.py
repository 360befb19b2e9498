"""The fused conv kernel's launch rule (mxtpu_torch/ops/pallas/conv.py:
_launch_args): route, staging, tiles, padded K and grid for CPU
tensors, with the SM count passed in (132, an H100 SXM's). The rule reads
only shapes, dtypes and data_ptr, so it runs here without a card; the C
entry point only refuses what would go out of bounds."""
import pytest
import torch

from mxtpu_torch.ops.pallas import conv as tpc

SMS = 132
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (name, batch, H=W, C_in, C_out, k, stride, pad): the 5 shapes the gate
# admits in one ResNet-50 v1 forward at batch 8
GATED = [
    ("stem", 8, 224, 3, 64, 7, 2, 3),
    ("1x1 64->64", 8, 56, 64, 64, 1, 1, 0),
    ("3x3 64->64", 8, 56, 64, 64, 3, 1, 1),
    ("1x1 64->256", 8, 56, 64, 256, 1, 1, 0),
    ("1x1 256->64", 8, 56, 256, 64, 1, 1, 0),
]


def _args(n, h, w, cin, cout, k, s, p, dtype, offset=0):
    dt = TDT[dtype]
    x = torch.zeros(n * h * w * cin + offset, dtype=dt)[offset:].view(
        n, h, w, cin)
    wt = torch.zeros(k, k, cin, cout, dtype=dt)
    pad = ((p, p), (p, p)) if isinstance(p, int) else p
    la = tpc._launch_args(x, wt, (s, s), pad, sms=SMS)
    oh = tpc.out_hw(h, pad[0][0], pad[0][1], k, s)
    ow = tpc.out_hw(w, pad[1][0], pad[1][1], k, s)
    return la, n * oh * ow


def _check_covers(la, m, cin, cout, k):
    """The grid covers M and C_out with no block wholly past either, and
    K pads to whole 16s."""
    gm, gn = la.grid
    assert gm * la.block_m >= m > (gm - 1) * la.block_m
    assert gn * la.block_n >= cout > (gn - 1) * la.block_n
    kk = k * k * cin
    assert la.k_pad % 16 == 0 and kk <= la.k_pad < kk + 16
    assert la.block_m in (64, 128) and la.block_n in (64, 128)
    if la.route == tpc.TENSOR_CORES:
        # one warpgroup of 128 threads a 64 rows
        assert la.threads == la.block_m // 64 * 128
    else:
        assert la.threads == la.block_m * la.block_n // 64   # 8 x 8 a thread


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,n,hw,cin,cout,k,s,p", GATED)
def test_gated_resnet50_shapes(name, n, hw, cin, cout, k, s, p, dtype):
    la, m = _args(n, hw, hw, cin, cout, k, s, p, dtype)
    assert la.dtype == (1 if dtype == "bfloat16" else 0)
    assert la.route == (tpc.TENSOR_CORES if dtype == "bfloat16"
                        else tpc.CUDA_CORES)
    # the stem's 3 channels fill no 16-byte piece: element-wise A staging;
    # every other gated conv stages A and B by 16-byte copies
    assert la.vec_a == (name != "stem")
    assert la.vec_b
    _check_covers(la, m, cin, cout, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_and_f32_tiles_at_the_gated_shapes(dtype):
    """bf16: 128-pixel blocks only where they fill the card twice (the
    stem, 784 blocks; 1x1 64->256 with two C_out tiles), else 64; f32:
    128 x 64 tiles for C_out 64, 64 x 128 above."""
    tiles = {name: _args(n, hw, hw, cin, cout, k, s, p, dtype)[0][4:6]
             for name, n, hw, cin, cout, k, s, p in GATED}
    if dtype == "bfloat16":
        assert tiles == {"stem": (128, 64), "1x1 64->64": (64, 64),
                         "3x3 64->64": (64, 64), "1x1 64->256": (128, 128),
                         "1x1 256->64": (64, 64)}
    else:
        assert tiles == {"stem": (128, 64), "1x1 64->64": (128, 64),
                         "3x3 64->64": (128, 64), "1x1 64->256": (64, 128),
                         "1x1 256->64": (128, 64)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_odd_shape_takes_elementwise_staging(dtype):
    """17x13, C_in = 5, stride 2, asymmetric padding: 5 channels fill no
    16-byte piece, so A is staged element by element; C_out 24 does."""
    la, m = _args(3, 17, 13, 5, 24, 3, 2, ((1, 0), (2, 1)), dtype)
    assert not la.vec_a and la.vec_b
    # OH = (17 + 1 - 3) // 2 + 1, OW = (13 + 3 - 3) // 2 + 1
    assert m == 3 * 8 * 7
    _check_covers(la, m, 5, 24, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_unaligned_view_takes_elementwise_staging(dtype, offset):
    """A contiguous view at a storage offset that breaks 16-byte alignment:
    A goes element-wise, B (its own aligned tensor) stays 16-byte."""
    la, m = _args(2, 56, 56, 64, 64, 1, 1, 0, dtype, offset=offset)
    assert not la.vec_a and la.vec_b
    _check_covers(la, m, 64, 64, 1)
    aligned, _ = _args(2, 56, 56, 64, 64, 1, 1, 0, dtype)
    assert aligned.vec_a
    assert la._replace(vec_a=True) == aligned


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 5])
@pytest.mark.parametrize("name,n,hw,cin,cout,k,s,p", GATED)
def test_m_tails_of_small_batches(name, n, hw, cin, cout, k, s, p, dtype,
                                  batch):
    la, m = _args(batch, hw, hw, cin, cout, k, s, p, dtype)
    _check_covers(la, m, cin, cout, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cout", [24, 96, 200, 5])
def test_cout_not_a_multiple_of_the_tile(dtype, cout):
    la, m = _args(4, 28, 28, 64, cout, 3, 1, 1, dtype)
    _check_covers(la, m, 64, cout, 3)
    assert la.block_n == (64 if cout <= 64 else 128)
    es = 2 if dtype == "bfloat16" else 4
    assert la.vec_b == ((cout * es) % 16 == 0)


def test_sm_count_moves_only_the_bf16_block_rows():
    """Fewer SMs: 128-pixel bf16 blocks fill the card sooner; f32 tiles and
    everything but the grid's row count stay."""
    x = torch.zeros(8, 56, 56, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16)
    pad = ((1, 1), (1, 1))
    big = tpc._launch_args(x, w, (1, 1), pad, sms=SMS)
    small = tpc._launch_args(x, w, (1, 1), pad, sms=8)
    assert (big.block_m, small.block_m) == (64, 128)
    assert small.grid == (25088 // 128, 1)
    f32 = [tpc._launch_args(x.float(), w.float(), (1, 1), pad, sms=s)
           for s in (SMS, 8)]
    assert f32[0] == f32[1]
