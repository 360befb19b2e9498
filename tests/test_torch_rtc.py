"""Runtime-compiled kernels of the port (mxtpu_torch.rtc, kernel B3) on the
CPU: source parsing and exports, the errors for Python/Pallas source,
argument marshalling and the default grid, the launches that must raise
(CPU arrays, a dtype that disagrees with a pointer parameter, mixed
devices), the build cache with a stand-in nvcc, and the plain versions of
chip_smoke.py's five example kernels against the JAX package's
PallasModule in interpret mode.

A CUDA kernel cannot run here; chip_smoke.py holds the kernels against
the same plain versions on the card.

Tolerances: float32 plain versions rtol 1e-6 of the operands' magnitude
(2.5|x| + |y| for axpy, where XLA may contract to an FMA), bfloat16 within
one bf16 ulp of the reference."""
import ctypes
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.rtc import PallasModule as JaxPallasModule
from mxtpu_torch import kernels, rtc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_examples", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()

SOURCE = r"""
#include <cuda_fp16.h>
/* a block comment: __global__ void commented_out(float* x) */
// __global__ void also_commented(float* x)
extern "C" __global__ void __launch_bounds__(128)
scale_add(const float* __restrict__ x, const __half* h, void* any,
          float alpha, double beta, int n, long long m, unsigned int u,
          int64_t k, size_t s, bool flag, float* out, int* counts) {}
__global__ void no_args() {}
static __global__ void ints(const int32_t* a, uint8_t* b, int64_t* c) {}
"""


# ------------------------------------------------------------------ parsing
def test_parse_kernels_reads_every_declaration():
    decls = rtc.parse_kernels(SOURCE)
    assert list(decls) == ["scale_add", "no_args", "ints"]
    p = decls["scale_add"]
    assert [(q.name, q.pointer) for q in p] == [
        ("x", True), ("h", True), ("any", True), ("alpha", False),
        ("beta", False), ("n", False), ("m", False), ("u", False),
        ("k", False), ("s", False), ("flag", False), ("out", True),
        ("counts", True)]
    assert [q.dtype for q in p if q.pointer] == [
        torch.float32, torch.float16, None, torch.float32, torch.int32]
    assert [q.scalar for q in p if not q.pointer] == [
        ctypes.c_float, ctypes.c_double, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_uint64, ctypes.c_bool]
    assert decls["no_args"] == []
    assert [q.dtype for q in decls["ints"]] == [torch.int32, torch.uint8,
                                                torch.int64]
    assert repr(p[0]) == "float* x"


@pytest.mark.parametrize("src,match", [
    ("__global__ void k(float** x) {}", "not a pointer or a plain scalar"),
    ("__global__ void k(float& x) {}", "not a pointer or a plain scalar"),
    ("__global__ void k(my_t* x) {}", "unsupported pointer type"),
    ("__global__ void k(float2 v) {}", "unsupported scalar type"),
    ("__global__ void k(float* x) {}\n__global__ void k(int* x) {}",
     "declared twice"),
], ids=["ptr-ptr", "reference", "struct-ptr", "vector-scalar", "overload"])
def test_parse_rejects_what_it_cannot_marshal(src, match):
    with pytest.raises(mt.MXNetError, match=match):
        rtc.CudaModule(src)


def test_exports_and_generated_launchers():
    mod = rtc.CudaModule(SOURCE, exports=["ints", "scale_add"])
    assert mod.kernel_names == ["ints", "scale_add"]
    gen = mod.generated_source
    assert gen.startswith(SOURCE)
    for name in ("ints", "scale_add"):
        assert ('extern "C" int mxrtc_launch_%s(void** args, const unsigned* '
                'dims, void* stream)' % name) in gen
        assert "cudaLaunchKernel((const void*)%s," % name in gen
    assert "mxrtc_launch_no_args" not in gen
    assert 'extern "C" const char* mxrtc_error_string' in gen
    with pytest.raises(mt.MXNetError, match="exports not found"):
        rtc.CudaModule(SOURCE, exports=["ints", "nope"])
    with pytest.raises(mt.MXNetError, match="not in module"):
        mod.get_kernel("no_args")
    with pytest.raises(mt.MXNetError, match="cannot have 4 outputs"):
        mod.get_kernel("ints", num_outputs=4)


def test_python_and_pallas_source_point_to_cuda():
    py = "def double(x_ref, o_ref):\n    o_ref[...] = 2.0 * x_ref[...]\n"
    with pytest.raises(mt.MXNetError, match="CUDA C\\+\\+"):
        rtc.CudaModule(py)
    with pytest.raises(mt.MXNetError, match="no Pallas runtime"):
        rtc.PallasModule(py)
    for src in ("#include <cuda_runtime.h>\nint x;\n",
                "// __global__ void only_in_a_comment(float* x)\n"):
        with pytest.raises(mt.MXNetError, match="no __global__ kernel"):
            rtc.CudaModule(src)
    # the JAX package is the mirror image: it refuses CUDA, runs Pallas
    with pytest.raises(mx.base.MXNetError, match="Pallas"):
        mx.rtc.CudaModule("__global__ void k(float* x) { x[0] = 1.f; }")
    out = mx.rtc.CudaModule(py).get_kernel("double").launch(
        [mx.nd.array(np.arange(4, dtype=np.float32))], (4,))
    np.testing.assert_allclose(out.asnumpy(), [0, 2, 4, 6])


# -------------------------------------------------- marshalling and launch
def test_pack_args_and_default_grid():
    k = rtc.CudaModule(SOURCE).get_kernel("scale_add", num_outputs=2)
    x = torch.arange(4, dtype=torch.float32)
    h = torch.zeros(4, dtype=torch.float16)
    anyt = torch.zeros(3, dtype=torch.int8)
    out = torch.zeros(4)
    cnt = torch.zeros(4, dtype=torch.int32)
    vals = [x, h, anyt, 2.5, 0.25, -7, 2 ** 40, 7, -3, 9, True, out, cnt]
    held = rtc.pack_args(k.params, vals)
    assert [h_.value for h_ in held[:3]] == [
        x.data_ptr(), h.data_ptr(), anyt.data_ptr()]
    assert [type(v) for v in held[3:11]] == [
        ctypes.c_float, ctypes.c_double, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_uint32, ctypes.c_int64, ctypes.c_uint64, ctypes.c_bool]
    assert [v.value for v in held[3:11]] == [2.5, 0.25, -7, 2 ** 40, 7, -3,
                                             9, True]
    assert held[-1].value == cnt.data_ptr()
    # cudaLaunchKernel reads each argument through its holder's address
    argv = (ctypes.c_void_p * len(held))(*[ctypes.addressof(v)
                                           for v in held])
    assert ctypes.cast(argv[3], ctypes.POINTER(ctypes.c_float))[0] == 2.5
    assert ctypes.cast(argv[0], ctypes.POINTER(ctypes.c_void_p))[0] == \
        x.data_ptr()
    # inputs fill the non-output parameters in order; the last two
    # pointers are the outputs
    assert [k.params[i].name for i in k._in_idx][-1] == "flag"
    assert [k.params[i].name for i in k._out_idx] == ["out", "counts"]
    assert rtc.launch_dims(None, None, 25557032) == ((99833, 1, 1),
                                                    (256, 1, 1))
    assert rtc.launch_dims(None, (32, 8), 1000) == ((4, 1, 1), (32, 8, 1))
    assert rtc.launch_dims((3, 2), 64, 1) == ((3, 2, 1), (64, 1, 1))
    assert rtc.launch_dims(None, None, 0) == ((1, 1, 1), (256, 1, 1))
    for grid, block, match in ((None, (1025,), "at most 1024"),
                               ((1, 70000), None, "exceeds"),
                               ((0,), None, "positive"),
                               ((1, 1, 1, 1), None, "1 to 3")):
        with pytest.raises(mt.MXNetError, match=match):
            rtc.launch_dims(grid, block, 10)


def _k(name="axpy", num_outputs=1):
    return rtc.CudaModule(CS.RTC_SOURCE).get_kernel(name, num_outputs)


@pytest.mark.parametrize("args,match", [
    ([torch.ones(4), torch.ones(4), 4], "no CPU path"),
    ([mt.nd.array(np.ones(4, np.float32), ctx=mt.cpu()),
      mt.nd.array(np.ones(4, np.float32), ctx=mt.cpu()), 4], "no CPU path"),
    ([torch.ones(4, dtype=torch.bfloat16), torch.ones(4), 4],
     "reads torch.float32, got a torch.bfloat16"),
    ([torch.ones(4), torch.ones(4)], "takes 3 arguments"),
    ([torch.ones(4), 1.0, 4], "takes an array"),
    ([torch.ones(4), torch.ones(4), torch.ones(1)], "takes a number"),
    ([torch.ones(4), torch.ones(4), 4.0], "takes a number"),
    ([torch.ones(4), torch.ones(4, device="meta"), 4], "several devices"),
], ids=["cpu-tensors", "cpu-ndarrays", "dtype", "count", "scalar-for-ptr",
        "tensor-for-scalar", "float-for-int", "mixed-devices"])
def test_launch_raises_rather_than_falling_back(args, match):
    k = _k()
    with pytest.raises(mt.MXNetError, match=match):
        k.launch(args, (4,))
    assert k.launches == 0


def test_output_dtypes_and_counts():
    k = _k()
    dev = torch.device("cpu")
    outs = k._outputs([torch.ones(2), torch.ones(2), 2], (2, 3), None, dev)
    assert [tuple(o.shape) for o in outs] == [(2, 3)]
    assert outs[0].dtype == torch.float32 and outs[0].is_contiguous()
    with pytest.raises(mt.MXNetError, match="writes torch.float32"):
        k._outputs([], (2,), "bfloat16", dev)
    with pytest.raises(mt.MXNetError, match="declared num_outputs=1"):
        k._outputs([], [(2,), (2,)], None, dev)
    with pytest.raises(mt.MXNetError, match="2 out_dtypes for 1"):
        k._outputs([], [(2,)], ["float32", "float32"], dev)
    # the default out dtype is the first array argument's
    kb = _k("axpy_bf16")
    x = mt.nd.array(np.ones(2, np.float32), ctx=mt.cpu(), dtype="bfloat16")
    assert kb._outputs([x], (2,), None, dev)[0].dtype == torch.bfloat16


def _argv_values(k, argv):
    """What cudaLaunchKernel would read through each entry of ``argv``."""
    return [ctypes.cast(argv[i], ctypes.POINTER(
        ctypes.c_void_p if p.pointer else p.scalar))[0]
        for i, p in enumerate(k.params)]


def test_prepared_argv_gives_pack_args_values_on_every_launch(fake_nvcc):
    """The argv a Kernel reuses holds exactly pack_args's values at each
    launch, for tensors and scalars that change from launch to launch (a
    stale pointer or scalar never reaches a later launch)."""
    k = rtc.CudaModule(SOURCE).build().get_kernel("scale_add",
                                                  num_outputs=2)
    seen = []
    def record(argv, dims, stream):
        argv = ctypes.cast(argv, ctypes.POINTER(ctypes.c_void_p))
        dims = ctypes.cast(dims, ctypes.POINTER(ctypes.c_uint))
        seen.append((_argv_values(k, argv), tuple(dims[:7]) + (stream,)))
        return 0
    launcher = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_void_p] * 3)(record)
    k._fn = launcher
    r = np.random.RandomState(3)
    for i in range(4):
        ins = [torch.from_numpy(r.randn(4 + i).astype(np.float32)),
               torch.zeros(3 + i, dtype=torch.float16),
               torch.zeros(i + 1, dtype=torch.int8),
               float(r.randn()), float(r.randn()), int(r.randint(-9, 9)),
               int(r.randint(0, 2 ** 40)), i, -i, 10 * i, bool(i % 2)]
        outs = [torch.empty(5 + i), torch.empty(2 + i, dtype=torch.int32)]
        assert k._run(ins, outs, (i + 1, 1, 1), (32, 1, 1), 0, 1234) == 0
        want = [h.value for h in rtc.pack_args(k.params, ins + outs)]
        got, dims = seen[-1]
        assert got[3] == pytest.approx(want[3]) and got[4] == want[4]
        assert got[:3] + got[5:] == want[:3] + want[5:]
        assert dims == (i + 1, 1, 1, 32, 1, 1, 0, 1234)
    assert len(seen) == 4 and k.launches == 0   # _run counts nothing


# ------------------------------------------------------------------ build
@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc: writes a loadable shared library (a copy of one of
    Python's own) to the -o path and counts its calls; a source holding
    FAIL makes it print an error and exit 1."""
    import _ctypes
    calls = tmp_path / "calls"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!%s\nimport shutil, sys\n"
        "open(%r, 'a').write('x')\n"
        "src = open(sys.argv[-1]).read()\n"
        "if 'FAIL' in src:\n"
        "    print('error: identifier \"no_such_name\" is undefined')\n"
        "    sys.exit(1)\n"
        "shutil.copy(%r, sys.argv[sys.argv.index('-o') + 1])\n"
        % (sys.executable, str(calls), _ctypes.__file__))
    script.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(script))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_LOADED", {})
    return lambda: len(calls.read_text()) if calls.exists() else 0


def test_build_cache_by_source_and_flags(fake_nvcc, tmp_path, monkeypatch):
    mod = rtc.CudaModule(CS.RTC_SOURCE).build()
    assert (mod.build_how, fake_nvcc()) == ("nvcc", 1)
    cu, so, log, digest = kernels.runtime_target(mod.generated_source)
    assert digest == mod.digest and so.exists()
    assert cu.parent == tmp_path / "build" / "rtc"
    assert cu.read_text() == mod.generated_source
    assert "sm_90a" in log.read_text() and mod.build_log() == log.read_text()
    again = rtc.CudaModule(CS.RTC_SOURCE).build()
    assert (again.build_how, fake_nvcc()) == ("memory", 1)
    monkeypatch.setattr(kernels, "_LOADED", {})   # a new process
    disk = rtc.CudaModule(CS.RTC_SOURCE).build()
    assert (disk.build_how, fake_nvcc()) == ("disk", 1)
    flags = rtc.CudaModule(CS.RTC_SOURCE, options=("-lineinfo",)).build()
    assert (flags.build_how, fake_nvcc()) == ("nvcc", 2)
    assert flags.digest != mod.digest
    # runtime sources never go into csrc/
    assert kernels.sources() == ["flash_attention", "fused_conv"]


def test_nvcc_failure_raises_with_the_log(fake_nvcc):
    bad = rtc.CudaModule("// FAIL\n__global__ void broken(float* x) "
                         "{ x[0] = no_such_name; }")
    with pytest.raises(mt.MXNetError, match="(?s)nvcc failed.*no_such_name"):
        bad.build()
    so = kernels.runtime_target(bad.generated_source)[1]
    assert not so.exists() and not list(so.parent.glob("*.tmp*"))


# ------------------------------------------- plain versions against Pallas
PALLAS_SOURCE = """
def axpy(x_ref, y_ref, out_ref):
    out_ref[...] = 2.5 * x_ref[...] + y_ref[...]

def square(x_ref, out_ref):
    out_ref[...] = x_ref[...] * x_ref[...]

def twice(x_ref, out_ref):
    out_ref[...] = 2.0 * x_ref[...]

def square_backward(x_ref, g_ref, dx_ref):
    dx_ref[...] = 2.0 * x_ref[...] * g_ref[...]

def axpy_bf16(x_ref, y_ref, out_ref):
    out_ref[...] = (2.5 * x_ref[...].astype(jnp.float32)
                    + y_ref[...].astype(jnp.float32)).astype(jnp.bfloat16)
"""


@pytest.mark.parametrize("name,n_in,dtype,rule,_lib", CS.RTC_KERNELS,
                         ids=[k[0] for k in CS.RTC_KERNELS])
def test_plain_versions_match_the_pallas_kernels(name, n_in, dtype, rule,
                                                 _lib):
    r = np.random.RandomState(11)
    xs = [r.randn(8, 128).astype(np.float32) for _ in range(n_in)]
    ja = [mx.nd.array(x, dtype=dtype) for x in xs]
    ta = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    ref = JaxPallasModule(PALLAS_SOURCE).get_kernel(name).launch(
        ja, out_shapes=(8, 128)).asnumpy()
    got = CS.RTC_PLAIN[name](*ta)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (8, 128)
    got = got.float().numpy()
    if rule == "ulp":
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                      - 7)
        assert (np.abs(got - ref) <= ulp).all()
    else:
        mag = CS.RTC_PLAIN[name](*[t.abs() for t in ta]).numpy()
        assert (np.abs(got - ref) <= 1e-6 * mag).all()
    # and the CUDA source declares the kernel the plain version stands for
    k = _k(name)
    assert [p.pointer for p in k.params] == [True] * (n_in + 1) + [False]
    assert {p.dtype for p in k.params if p.pointer} == {getattr(torch,
                                                                dtype)}
