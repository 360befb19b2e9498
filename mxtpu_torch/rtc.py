"""Runtime kernel compilation: user-written CUDA C++ launched on NDArrays
(counterpart of ``mxtpu/rtc.py``, kernel B3).

The JAX package's ``CudaModule`` refuses CUDA and runs Python/Pallas source
through ``PallasModule`` + ``pl.pallas_call``. The port is the mirror
image: its native kernel language is CUDA, so ``CudaModule`` takes CUDA
C++ source and ``PallasModule`` only raises with that guidance.

* ``CudaModule(source, options, exports)`` parses every ``__global__ void``
  declaration of the source (or those named in ``exports``).
* ``get_kernel(name, num_outputs)`` returns a ``Kernel``; as with Pallas,
  the last ``num_outputs`` pointer parameters are the outputs, and
  ``launch`` fills the others in declaration order: NDArrays or tensors
  for pointers, Python numbers for ``int``/``int64_t``/``float``/``double``
  and the other plain scalar types.
* The build is ``mxtpu_torch.kernels.runtime_library``: the source plus one
  generated ``extern "C"`` launcher per exported kernel (which calls
  ``cudaLaunchKernel`` with a ``void**`` argument array and returns the
  error code) is compiled by nvcc with the package's flags (``sm_90a``)
  into ``build/mxtpu_torch/rtc/<sha256>.so``, loaded with ctypes and kept
  in-process. A CUDA kernel compiles once per source, not once per launch
  signature. The build happens at the first launch or at ``build()``.
* ``launch`` runs on ``torch.cuda.current_stream()`` of the arguments'
  device and returns NDArrays (one, or a list). Inputs that are not
  contiguous are copied to contiguous tensors first (a raw pointer sees
  storage, not a view); outputs are fresh and contiguous.
* The host path of a launch is kept short, since an eager launch's issue
  can take as long as a streaming kernel's device time: each ``Kernel``
  keeps one ``void*`` argument array whose typed holders are all set in
  place on every launch (under a lock, with the tensors alive until
  ``cudaLaunchKernel`` returns), reads the stream handle without building
  a ``torch.cuda.Stream``, and enters the device context only when the
  arguments' device is not the current one.

No fallback hides the device or the kernel: a launch on CPU tensors, on
tensors of several devices, with a dtype that disagrees with a pointer
parameter's C type, an nvcc failure or a nonzero ``cudaLaunchKernel``
code each raise ``MXNetError``. Each ``Kernel`` counts its launches in
``launches``.
"""
from __future__ import annotations

import ctypes
import numbers
import re
import threading
import time

import torch

from . import kernels
from .base import MXNetError, torch_dtype
from .context import resolve_device
from .graphs import launched
from .ndarray import NDArray

__all__ = ["CudaModule", "Kernel", "PallasModule"]

# pointer parameters: the tensor dtype each C type reads (None: any)
_POINTER_DTYPES = {
    "float": torch.float32, "double": torch.float64,
    "__half": torch.float16, "half": torch.float16,
    "__nv_bfloat16": torch.bfloat16, "nv_bfloat16": torch.bfloat16,
    "int": torch.int32, "int32_t": torch.int32,
    "long long": torch.int64, "long long int": torch.int64,
    "int64_t": torch.int64, "long": torch.int64,
    "short": torch.int16, "int16_t": torch.int16,
    "char": torch.int8, "signed char": torch.int8, "int8_t": torch.int8,
    "unsigned char": torch.uint8, "uint8_t": torch.uint8,
    "bool": torch.bool, "void": None,
}
# scalar parameters: the ctypes type each C type is passed as
_SCALAR_CTYPES = {
    "int": ctypes.c_int32, "int32_t": ctypes.c_int32,
    "unsigned": ctypes.c_uint32, "unsigned int": ctypes.c_uint32,
    "uint32_t": ctypes.c_uint32,
    "long long": ctypes.c_int64, "long long int": ctypes.c_int64,
    "int64_t": ctypes.c_int64, "long": ctypes.c_int64,
    "unsigned long long": ctypes.c_uint64, "uint64_t": ctypes.c_uint64,
    "size_t": ctypes.c_uint64,
    "float": ctypes.c_float, "double": ctypes.c_double,
    "bool": ctypes.c_bool,
}
_QUALIFIERS = {"const", "volatile", "__restrict__", "__restrict", "restrict"}
_KERNEL_RE = re.compile(
    r"__global__\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?void\s+"
    r"(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\(([^)]*)\)")
_DEFAULT_BLOCK = (256, 1, 1)
# launcher(void** argv, unsigned dims[7] = {gx, gy, gz, bx, by, bz, shared
# bytes}, stream), every argument passed as an address (the cheapest
# ctypes conversion)
_LAUNCHER_ARGTYPES = [ctypes.c_void_p] * 3


class Param:
    """One kernel parameter: its C type, name, and for a pointer the tensor
    dtype it reads (None for ``void*``), else the ctypes scalar type."""

    __slots__ = ("ctype", "name", "pointer", "dtype", "scalar")

    def __init__(self, ctype, name, pointer, dtype=None, scalar=None):
        self.ctype, self.name, self.pointer = ctype, name, pointer
        self.dtype, self.scalar = dtype, scalar

    def __repr__(self):
        return "%s%s %s" % (self.ctype, "*" if self.pointer else "",
                            self.name)


def _strip_comments(src):
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    return re.sub(r"//[^\n]*", " ", src)


def _parse_param(text, kernel, i):
    if text.count("*") > 1 or "&" in text or "[" in text:
        raise MXNetError("kernel %r: parameter %r is not a pointer or a "
                         "plain scalar" % (kernel, text.strip()))
    pointer = "*" in text
    type_part, _, name_part = text.partition("*") if pointer \
        else (text, "", "")
    words = [w for w in re.findall(r"[A-Za-z_]\w*", type_part)
             if w not in _QUALIFIERS]
    names = [w for w in re.findall(r"[A-Za-z_]\w*", name_part)
             if w not in _QUALIFIERS]
    if not pointer and len(words) > 1:
        names, words = words[-1:], words[:-1]
    ctype = " ".join(words)
    name = names[0] if names else "arg%d" % i
    if pointer:
        if ctype not in _POINTER_DTYPES:
            raise MXNetError("kernel %r: unsupported pointer type %r" %
                             (kernel, ctype + "*"))
        return Param(ctype, name, True, dtype=_POINTER_DTYPES[ctype])
    if ctype not in _SCALAR_CTYPES:
        raise MXNetError("kernel %r: unsupported scalar type %r" %
                         (kernel, ctype))
    return Param(ctype, name, False, scalar=_SCALAR_CTYPES[ctype])


def parse_kernels(source):
    """{name: [Param, ...]} of every ``__global__ void`` kernel declared in
    CUDA C++ ``source``, in declaration order."""
    out = {}
    for m in _KERNEL_RE.finditer(_strip_comments(source)):
        name, plist = m.group(1), m.group(2).strip()
        if name in out:
            raise MXNetError("kernel %r is declared twice (overloads are not "
                             "supported)" % name)
        parts = [] if plist in ("", "void") else plist.split(",")
        out[name] = [_parse_param(p, name, i) for i, p in enumerate(parts)]
    return out


def launcher_source(names):
    """The ``extern "C"`` launchers appended to a module's source: one per
    kernel, calling ``cudaLaunchKernel`` with the ``void**`` argument array
    and the launch's grid, block and shared-memory bytes read from one
    ``unsigned[7]`` (raising the dynamic shared-memory limit first when a
    launch asks for more than 48 KB), plus an error-string helper."""
    lines = ["", "// launchers generated by mxtpu_torch.rtc",
             "#include <cuda_runtime.h>",
             'extern "C" const char* mxrtc_error_string(int e) {',
             "  return cudaGetErrorString((cudaError_t)e);", "}"]
    for name in names:
        lines += [
            'extern "C" int mxrtc_launch_%s(void** args, '
            "const unsigned* dims, void* stream) {" % name,
            "  if (dims[6] > 49152) {",
            "    cudaError_t e = cudaFuncSetAttribute((const void*)%s, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dims[6]);"
            % name,
            "    if (e != cudaSuccess) return (int)e;",
            "  }",
            "  return (int)cudaLaunchKernel((const void*)%s, "
            "dim3(dims[0], dims[1], dims[2]), "
            "dim3(dims[3], dims[4], dims[5]), "
            "args, (size_t)dims[6], (cudaStream_t)stream);"
            % name,
            "}"]
    return "\n".join(lines) + "\n"


def _looks_like_python(source):
    return re.search(r"^\s*(def|import|from)\s+\w", source, re.M) is not None


class CudaModule:
    """CUDA C++ source compiled at runtime (ref: python/mxnet/rtc.py
    CudaModule).

    Parameters
    ----------
    source : str
        CUDA C++ source declaring one or more ``__global__ void`` kernels.
    options : sequence of str
        Extra nvcc flags, after the package's own (``sm_90a``, ``-O3``).
    exports : sequence of str
        Kernel names to export; default every ``__global__`` kernel.
    """

    def __init__(self, source, options=(), exports=()):
        if "__global__" not in source and _looks_like_python(source):
            raise MXNetError(
                "mxtpu_torch.rtc.CudaModule takes CUDA C++ source and this "
                "looks like Python (a Pallas kernel?): the port has no "
                "Pallas runtime. Write the kernel as a CUDA __global__ "
                "function (pointers in, the last pointer(s) are outputs) — "
                "see mxtpu_torch/rtc.py.")
        decls = parse_kernels(source)
        if not decls:
            raise MXNetError("no __global__ kernel functions found in source")
        if exports:
            missing = [e for e in exports if e not in decls]
            if missing:
                raise MXNetError("exports not found in source: %s" % missing)
            decls = {k: decls[k] for k in exports}
        self.source = source
        self.options = tuple(options)
        self._decls = decls
        self._lib = None
        self.digest = None
        self.build_how = None       # "nvcc", "disk" or "memory"
        self.build_seconds = None

    @property
    def kernel_names(self):
        return list(self._decls)

    @property
    def generated_source(self):
        """What nvcc compiles: the source and the generated launchers."""
        return self.source + launcher_source(self._decls)

    def build(self):
        """Compile (or load from the build cache) now; returns self."""
        if self._lib is None:
            t0 = time.perf_counter()
            self._lib, self.digest, self.build_how = kernels.runtime_library(
                self.generated_source, self.options)
            self.build_seconds = time.perf_counter() - t0
        return self

    def build_log(self):
        """nvcc's output for this module (ptxas lines), or '' when it was
        not compiled in this build directory."""
        log = kernels.runtime_target(self.generated_source, self.options)[2]
        return log.read_text() if log.exists() else ""

    def get_kernel(self, name, num_outputs=1):
        """Kernel by name (ref: rtc.py:get_kernel; the parameter list comes
        from the declaration, not a signature string)."""
        if name not in self._decls:
            raise MXNetError("kernel %r not in module (have: %s)"
                             % (name, sorted(self._decls)))
        return Kernel(self, name, self._decls[name], num_outputs)

    def _launcher(self, name):
        fn = getattr(self.build()._lib, "mxrtc_launch_" + name)
        fn.argtypes = _LAUNCHER_ARGTYPES
        fn.restype = ctypes.c_int
        return fn

    def _error_string(self, code):
        fn = self._lib.mxrtc_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        return fn(code).decode()


def _dims(v, what):
    if v is None:
        return None
    v = (v,) if isinstance(v, numbers.Integral) else tuple(v)
    if not 1 <= len(v) <= 3 or any(int(x) < 1 for x in v):
        raise MXNetError("%s must be 1 to 3 positive ints, got %r"
                         % (what, v))
    return tuple(int(x) for x in v) + (1,) * (3 - len(v))


def launch_dims(grid, block, numel):
    """(grid, block) as 3-tuples: ``block`` defaults to (256,), ``grid`` to
    enough blocks to cover ``numel`` threads."""
    block = _dims(block, "block") or _DEFAULT_BLOCK
    threads = block[0] * block[1] * block[2]
    if threads > 1024:
        raise MXNetError("block %s has %d threads; the card takes at most "
                         "1024" % (block, threads))
    grid = _dims(grid, "grid") or (max(1, -(-numel // threads)), 1, 1)
    if grid[0] > 2 ** 31 - 1 or grid[1] > 65535 or grid[2] > 65535:
        raise MXNetError("grid %s exceeds the card's limits" % (grid,))
    return grid, block


def _public_stream(index):
    return torch.cuda.current_stream(index).cuda_stream


# the raw handle of a device's current CUDA stream (by index), without
# building a torch.cuda.Stream, and the current device's index: torch's
# own bindings, or the public calls where a build of torch lacks them
_current_stream = getattr(torch._C, "_cuda_getCurrentRawStream",
                          _public_stream)
_current_device = getattr(torch._C, "_cuda_getDevice",
                          torch.cuda.current_device)


class Kernel:
    """A launchable kernel of a ``CudaModule`` (ref: rtc.py:Kernel)."""

    def __init__(self, module, name, params, num_outputs=1):
        ptrs = [i for i, p in enumerate(params) if p.pointer]
        if not 1 <= num_outputs <= len(ptrs):
            raise MXNetError("kernel %r has %d pointer parameters, so it "
                             "cannot have %d outputs" % (name, len(ptrs),
                                                         num_outputs))
        self.name = name
        self.params = params
        self._module = module
        self._num_outputs = num_outputs
        self._out_idx = ptrs[len(ptrs) - num_outputs:]
        self._in_idx = [i for i in range(len(params))
                        if i not in self._out_idx]
        self._fn = None
        self.launches = 0
        # the prepared argument array: one typed holder per parameter, each
        # set in place by every launch (cudaLaunchKernel reads them through
        # argv and copies them before it returns)
        self._holders = [ctypes.c_void_p() if p.pointer else p.scalar()
                         for p in params]
        self._argv = (ctypes.c_void_p * max(1, len(params)))(
            *[ctypes.addressof(h) for h in self._holders])
        # per input: (param, the number type a scalar takes or None for a
        # pointer, the conversion of a scalar)
        self._in_specs = []
        for i in self._in_idx:
            p = params[i]
            real = p.scalar in (ctypes.c_float, ctypes.c_double)
            self._in_specs.append(
                (p, None, None) if p.pointer else
                (p, numbers.Real, float) if real else
                (p, numbers.Integral, int))
        self._in_holders = [(self._holders[i], params[i].pointer)
                            for i in self._in_idx]
        self._out_holders = [self._holders[i] for i in self._out_idx]
        self._argv_addr = ctypes.addressof(self._argv)
        self._dims = (ctypes.c_uint * 7)()
        self._dims_addr = ctypes.addressof(self._dims)
        self._dims_key = None
        # the last launch's (grid, block) and (out_shapes, out_dtypes), and
        # what they normalized to: a caller that repeats them pays for one
        # check
        self._last_dims = self._last_spec = (None, None)
        self._lock = threading.Lock()

    def __repr__(self):
        return "Kernel %s(%s) -> %d output(s)" % (
            self.name, ", ".join(map(repr, self.params)), self._num_outputs)

    def _inputs(self, args):
        """(values in declaration order of the inputs, device)."""
        if len(args) != len(self._in_specs):
            raise MXNetError("kernel %r takes %d arguments (%s), got %d" % (
                self.name, len(self._in_idx), ", ".join(
                    repr(self.params[i]) for i in self._in_idx), len(args)))
        values, device = [], None
        for (p, kind, conv), a in zip(self._in_specs, args):
            if isinstance(a, NDArray):
                a = a._data
            if kind is None:   # a pointer
                if not isinstance(a, torch.Tensor):
                    raise MXNetError("kernel %r: parameter %r takes an array, "
                                     "got %s" % (self.name, p,
                                                 type(a).__name__))
                if p.dtype is not None and a.dtype != p.dtype:
                    raise MXNetError("kernel %r: parameter %r reads %s, got a "
                                     "%s array" % (self.name, p, p.dtype,
                                                   a.dtype))
                if device is None:
                    device = a.device
                elif a.device != device:
                    raise MXNetError("kernel %r: arrays on several devices %s"
                                     % (self.name, sorted({str(device),
                                                           str(a.device)})))
                values.append(a if a.is_contiguous() else a.contiguous())
            else:
                if not isinstance(a, kind):
                    raise MXNetError("kernel %r: parameter %r takes a number, "
                                     "got %s" % (self.name, p,
                                                 type(a).__name__))
                values.append(conv(a))
        if device is None:
            device = resolve_device(None)
        if device.type != "cuda":
            raise MXNetError("kernel %r: CUDA C++ source has no CPU path; "
                             "launch it on CUDA arrays (got %s)"
                             % (self.name, device))
        return values, device

    def _out_spec(self, out_shapes, out_dtypes):
        """(shapes, torch dtypes or None for "the first array's") of a
        launch's outputs, checked against the output parameters."""
        key, spec = self._last_spec
        if key is not None and key == (out_shapes, out_dtypes):
            return spec
        shapes = out_shapes
        if isinstance(shapes, (tuple, list)) and (
                not shapes or isinstance(shapes[0], numbers.Integral)):
            shapes = [shapes]
        shapes = [tuple(sh) for sh in shapes]
        n_out = len(shapes)
        dtypes = out_dtypes
        if dtypes is not None:
            if not isinstance(dtypes, (list, tuple)):
                dtypes = [dtypes] * n_out
            if len(dtypes) != n_out:
                raise MXNetError("launch: %d out_dtypes for %d out_shapes"
                                 % (len(dtypes), n_out))
            dtypes = [torch_dtype(dt) for dt in dtypes]
        if n_out != self._num_outputs:
            raise MXNetError("kernel %r declared num_outputs=%d but launch "
                             "got %d out_shapes" % (self.name,
                                                    self._num_outputs, n_out))
        if dtypes is not None:
            self._check_out_dtypes(dtypes)
        spec = (shapes, dtypes)
        self._last_spec = ((out_shapes, out_dtypes), spec)
        return spec

    def _check_out_dtypes(self, dtypes):
        for i, dt in zip(self._out_idx, dtypes):
            p = self.params[i]
            if p.dtype is not None and dt != p.dtype:
                raise MXNetError("kernel %r: output %r writes %s, but its "
                                 "out_dtype is %s" % (self.name, p, p.dtype,
                                                      dt))

    def _outputs(self, args, out_shapes, out_dtypes, device):
        """Fresh contiguous outputs; one of the first array argument's
        shape, type and device is its ``empty_like`` (the cheaper call)."""
        shapes, dtypes = self._out_spec(out_shapes, out_dtypes)
        first = None
        for a in args:
            if isinstance(a, NDArray):
                first = a._data
                break
            if isinstance(a, torch.Tensor):
                first = a
                break
        if dtypes is None:
            dtypes = [torch.float32 if first is None else first.dtype] \
                * len(shapes)
            self._check_out_dtypes(dtypes)
        outs = []
        for sh, dt in zip(shapes, dtypes):
            if first is not None and first.dtype == dt \
                    and first.device == device and first.shape == sh \
                    and first.is_contiguous():
                outs.append(torch.empty_like(first))
            else:
                outs.append(torch.empty(sh, dtype=dt, device=device))
        return outs

    def launch(self, args, out_shapes, out_dtypes=None, grid=None,
               block=None, shared_mem=0):
        """Run the kernel (ref: rtc.py:Kernel.launch).

        args : the non-output parameters in declaration order.
        out_shapes : one shape, or a list of shapes (one per output).
        out_dtypes : default: the first array argument's dtype.
        grid, block : CUDA launch dimensions; ``block`` defaults to (256,),
            ``grid`` to enough blocks to cover the first output's numel.
        shared_mem : dynamic shared memory in bytes.
        """
        values, device = self._inputs(args)
        outs = self._outputs(args, out_shapes, out_dtypes, device)
        key, dims = self._last_dims
        if grid is None or key != (grid, block):
            dims = launch_dims(grid, block, outs[0].numel())
            self._last_dims = ((grid, block), dims) if grid is not None \
                else (None, None)
        self._call(values, outs, *dims, int(shared_mem), device)
        if len(outs) == 1:
            return NDArray(outs[0])
        return [NDArray(o) for o in outs]

    def _call(self, values, outs, grid, block, shared_mem, device):
        """Launch on ``device``'s current stream, entering its context only
        when it is not the current device; raises on a nonzero code."""
        stream = _current_stream(device.index)
        if device.index == _current_device():
            rc = self._run(values, outs, grid, block, shared_mem, stream)
        else:
            with torch.cuda.device(device):
                rc = self._run(values, outs, grid, block, shared_mem, stream)
        if rc != 0:
            raise MXNetError("rtc kernel %r launch failed: CUDA error %d (%s)"
                             % (self.name, rc,
                                self._module._error_string(rc)))
        launched(self)

    def _run(self, values, outs, grid, block, shared_mem, stream):
        """Set every holder of the prepared argv (the inputs' pointers and
        scalars, the outputs' pointers: ``pack_args``'s values) and the
        dims when they changed, and call the launcher; returns its CUDA
        code. The caller keeps ``values`` and ``outs`` alive until this
        returns."""
        if self._fn is None:
            self._fn = self._module._launcher(self.name)
        key = (grid, block, shared_mem)
        with self._lock:
            for (h, pointer), v in zip(self._in_holders, values):
                h.value = v.data_ptr() if pointer else v
            for h, o in zip(self._out_holders, outs):
                h.value = o.data_ptr()
            if key != self._dims_key:
                self._dims[:] = [*grid, *block, shared_mem]
                self._dims_key = key
            return self._fn(self._argv_addr, self._dims_addr, stream)


def pack_args(params, values):
    """One ctypes value per parameter, in order: a tensor's data pointer or
    the scalar in its C type; the values ``Kernel._run`` sets in its
    prepared holders. ``cudaLaunchKernel`` reads each through the address
    of its holder, so a caller that launches with these keeps the list
    alive until the launch returns."""
    return [ctypes.c_void_p(v.data_ptr()) if p.pointer else p.scalar(v)
            for p, v in zip(params, values)]


class PallasModule:
    """Only here to say where Pallas source goes: the port's runtime
    kernels are CUDA C++ (``CudaModule``)."""

    def __init__(self, source, exports=None):
        raise MXNetError(
            "mxtpu_torch.rtc.PallasModule: the port has no Pallas runtime. "
            "Write the kernel as CUDA C++ and use mxtpu_torch.rtc.CudaModule "
            "(a __global__ function; pointers in, the last pointer(s) are "
            "outputs) — see mxtpu_torch/rtc.py.")

