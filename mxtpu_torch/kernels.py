"""Build and load the hand-written CUDA kernels of ``mxtpu_torch/csrc/``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes``. Libraries land in ``build/mxtpu_torch/`` beside the package
(the checkout's ``.gitignore`` lists ``build/``), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is. ``build_all()`` starts one ``nvcc`` per source, all at
once, and waits for every one of them.

Runtime sources (``mxtpu_torch.rtc``) take the same road with the same
flags: ``runtime_library`` writes the generated source to
``build/mxtpu_torch/rtc/<sha256 of source and flags>.cu``, compiles it into
a ``.so`` beside it (an unchanged source is loaded as it is) and keeps the
loaded library in-process under that hash. They never go into ``csrc/``.

Both kinds also go into the compile service's cache dir
(``compile_service.set_cache_dir``): with one set, ``library`` and
``runtime_library`` look in ``<cache dir>/kernels/`` under the same
source-and-flags name before they run nvcc, and copy what nvcc built there
(a temporary file, then a rename). The compile service's blobs name these
files, so a fresh process pointed at the cache dir loads every library it
needs without nvcc, whatever its own build directory holds. Runtime
libraries resolve through the compile service at site ``rtc``, under its
LRU bound; an evicted one stays loaded while a ``Kernel`` holds it (a
loaded library is never unloaded). ``nvcc_runs()`` counts the nvcc
processes started, as does the telemetry counter ``kernels.nvcc``.

Nothing here runs when the package is imported: the host that runs the
CPU tests has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .base import MXNetError

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "library",
           "library_file", "build_all", "build_log", "runtime_target",
           "runtime_library", "cache_path", "nvcc_runs"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "mxtpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED = {}
_NVCC = [0]   # nvcc processes started in this process


def sources():
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                         "the CUDA kernels cannot be built on this host")
    return found


def _target(name):
    """(shared-library path, log path) for csrc/<name>.cu at its hash."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):   # the .cu and any shared .cuh
        if p.suffix == ".cuh" or p.stem == name:
            h.update(p.name.encode())
            h.update(p.read_bytes())
    stem = "%s-%s" % (name, h.hexdigest()[:16])
    return BUILD_DIR / (stem + ".so"), BUILD_DIR / (stem + ".log")


def library_file(name):
    """The file name csrc/<name>.cu's library has at its current hash."""
    return _target(name)[0].name


def cache_path(filename):
    """``<cache dir>/kernels/<filename>``, or None without a cache dir."""
    from . import compile_service
    root = compile_service.cache_dir()
    return None if not root else Path(root) / "kernels" / filename


def _publish(so):
    """Copy a built library into the cache dir (once), atomically."""
    dst = cache_path(so.name)
    if dst is None or dst.exists():
        return
    try:
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_suffix(".so.tmp%d" % os.getpid())
        shutil.copyfile(so, tmp)
        os.replace(tmp, dst)
    except OSError:   # a full disk costs the next process a build
        from . import telemetry
        telemetry.inc("kernels.cache_write_errors")


def file_of(name):
    """The file name of a library as the compile service's blobs name it:
    a csrc source's at its hash, ``rtc/<digest>``'s ``<digest>.so``."""
    if name.startswith("rtc/"):
        return name[4:] + ".so"
    return library_file(name)


def nvcc_runs():
    """nvcc processes started by this process."""
    return _NVCC[0]


def _spawn(src, so, log, flags):
    """Start nvcc compiling ``src`` into a temporary file beside ``so``."""
    from . import telemetry
    tmp = so.with_suffix(".so.tmp%d" % os.getpid())
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    _NVCC[0] += 1
    telemetry.inc("kernels.nvcc")
    logf = open(log, "w")
    logf.write(" ".join(cmd) + "\n")
    logf.flush()
    proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
    return proc, logf, tmp, so, log


def _start(name):
    """Popen compiling csrc/<name>.cu, or None when the library is already
    built (here or in the cache dir)."""
    so, log = _target(name)
    cached = cache_path(so.name)
    if so.exists():
        _publish(so)   # a cache dir set after the build gets it too
        return None
    if cached is not None and cached.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _spawn(CSRC / (name + ".cu"), so, log, NVCC_FLAGS)


def _finish(label, started):
    proc, logf, tmp, so, log = started
    rc = proc.wait()
    logf.close()
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError("nvcc failed on %s (exit %d):\n%s"
                         % (label, rc, log.read_text()[-4000:]))
    os.replace(tmp, so)   # atomic: a concurrent build sees all or nothing
    _publish(so)


def _reap(started):
    """Never leave an nvcc running."""
    if started[0].poll() is None:
        started[0].kill()
        started[0].wait()
    started[1].close()


def build_all(names=None):
    """Build every missing kernel library in parallel; returns the names."""
    names = list(names or sources())
    with _LOCK:
        started = {}
        try:
            for n in names:
                started[n] = _start(n)
            for n, s in started.items():
                if s is not None:
                    _finish("csrc/%s.cu" % n, s)
        finally:
            for s in started.values():
                if s is not None:
                    _reap(s)
    return names


def build_log(name):
    """The nvcc output of the last build of ``name`` (ptxas register and
    shared-memory use), or '' when it was built by an earlier process."""
    _, log = _target(name)
    return log.read_text() if log.exists() else ""


def library(name):
    """The loaded ctypes library of csrc/<name>.cu, built on first use (the
    cache dir's copy first, when it has one)."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LOADED:
            so = _target(name)[0]
            cached = cache_path(so.name)
            _LOADED[name] = ctypes.CDLL(str(
                cached if cached is not None and cached.exists() else so))
        return _LOADED[name]


def runtime_target(text, options=()):
    """(source path, library path, log path, digest) of a runtime source:
    named by the sha256 of the text and the nvcc flags."""
    flags = NVCC_FLAGS + tuple(options)
    digest = hashlib.sha256(("\0".join(flags) + "\0" + text).encode()
                            ).hexdigest()
    d = BUILD_DIR / "rtc"
    return (d / (digest + ".cu"), d / (digest + ".so"), d / (digest + ".log"),
            digest)


def runtime_library(text, options=()):
    """``(library, digest, how)`` for a runtime CUDA source, resolved
    through the compile service at site ``rtc``: ``how`` is "memory"
    (loaded earlier in this process), "disk" (built by an earlier process
    into the build directory), "cache" (found in the cache dir) or "nvcc"
    (compiled now). An nvcc failure raises ``MXNetError`` with the tail of
    its log."""
    from . import compile_service
    digest = runtime_target(text, options)[3]
    key = compile_service.canonical_key(
        site="rtc", fn_id="rtc:" + digest, signature=(),
        device=compile_service.device_token())
    how = ["memory"]

    def build():
        lib, how[0] = _load_runtime(text, options)
        compile_service.note_library("rtc/" + digest, digest + ".so")
        return lib

    entry = compile_service.get_or_build(key, build, provenance={
        "digest": digest, "options": list(options)})
    # and for a build this call runs inside (a capture that launches it)
    compile_service.note_library("rtc/" + digest, digest + ".so")
    return entry.fn, digest, how[0]


def _load_runtime(text, options):
    """(library, how) of a runtime source not loaded in this process."""
    cu, so, log, digest = runtime_target(text, options)
    with _LOCK:
        cached = cache_path(so.name)
        if so.exists():
            _publish(so)
            return ctypes.CDLL(str(so)), "disk"
        if cached is not None and cached.exists():
            return ctypes.CDLL(str(cached)), "cache"
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = cu.with_suffix(".cu.tmp%d" % os.getpid())
        tmp.write_text(text)
        os.replace(tmp, cu)
        started = _spawn(cu, so, log, NVCC_FLAGS + tuple(options))
        try:
            _finish("runtime source %s" % cu.name, started)
        finally:
            _reap(started)
        return ctypes.CDLL(str(so)), "nvcc"
