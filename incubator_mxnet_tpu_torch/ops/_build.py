"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into the
git-ignored ``_build/`` directory of the package, and loaded with
``ctypes``.  The library's file name carries a hash of its source and
of every header ``csrc/*.cuh`` (which the sources include), so an
edited source or header is rebuilt and a stale library is never loaded.
Sources build in parallel: one ``nvcc`` process per source, all started
together.

``build_source`` / ``load_source`` do the same for a kernel given as
source text (``rtc.compile_kernel``): the text is written to
``_build/rtc/<name>-<sha1>.cu`` and compiled with the same flags into
``_build/rtc/lib<name>-<sha1>.so``, where the hash is of the text.
Only ``csrc/*.cu`` are the package's own kernels: the user-kernel
sources under ``csrc/rtc/`` reach ``nvcc`` through ``rtc`` alone.
nvcc's resource report (``-Xptxas -v``) is kept beside each library
as ``.log``.

``LAUNCHES`` counts each kernel's launches: a wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that its path
went through the kernels.
"""
import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["LAUNCHES", "reset_launches", "build", "load", "sources",
           "build_source", "load_source"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
RTC_DIR = BUILD_DIR / "rtc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = collections.Counter()
_LIBS = {}


def reset_launches():
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()


def sources():
    """Kernel name -> source path, for every ``csrc/*.cu`` (a header
    ``*.cuh`` is never built alone)."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from source at first use")


def _target(src):
    """The library of ``src``, named by a hash of the source and of
    every ``csrc/*.cuh``."""
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def _compile(jobs):
    """Run one ``nvcc`` per ``{name: (source path, target)}``, all
    together; each log goes beside its library.  Returns ``{name:
    {"path", "seconds", "log"}}``; raises ``RuntimeError`` with nvcc's
    output if a build fails."""
    if not jobs:
        return {}
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = {}
    for name, (src, target) in jobs.items():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built, failed = {}, {}
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed[name] = log
            continue
        target = jobs[name][1]
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
        built[name] = {"path": str(target),
                       "seconds": time.monotonic() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{log}" for n, log in failed.items()))
    return built


def build(names=None):
    """Compile the named kernels (default: all) that are not built yet.

    Returns ``{name: {"path", "seconds", "log"}}`` for the kernels built
    by this call; ``log`` holds nvcc's resource report (registers,
    shared memory, spills).  Raises ``RuntimeError`` with nvcc's output
    if a build fails.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    missing = [n for n in names if n not in srcs]
    if missing:
        raise KeyError(f"no kernel source for {missing} in {CSRC}")
    return _compile({n: (srcs[n], _target(srcs[n])) for n in names
                     if not _target(srcs[n]).exists()})


def _source_target(text, name):
    digest = hashlib.sha1(text.encode()).hexdigest()[:12]
    return RTC_DIR / f"lib{name}-{digest}.so"


def build_source(text, name):
    """Compile the CUDA source ``text`` as kernel ``name``, unless it is
    built already.  Returns ``{"path", "seconds", "log", "cached"}``:
    ``log`` is nvcc's resource report of the build, ``seconds`` 0.0 and
    ``cached`` True when the library was there before."""
    target = _source_target(text, name)
    if target.exists():
        return {"path": str(target), "seconds": 0.0, "cached": True,
                "log": target.with_suffix(".log").read_text()}
    src = target.with_name(target.stem[len("lib"):] + ".cu")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return dict(_compile({name: (src, target)})[name], cached=False)


def _bind(path, signatures):
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def load(name, signatures):
    """The loaded library of kernel ``name``, built first if needed.
    ``signatures`` maps each C function to ``(argtypes, restype)``;
    pointers and streams must be ``c_void_p``, or ctypes cuts them to
    32 bits."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = _bind(_target(sources()[name]), signatures)
    return lib


def load_source(text, name, signatures):
    """The loaded library of the CUDA source ``text`` (kernel ``name``),
    built first if needed; ``signatures`` as for :func:`load`."""
    target = _source_target(text, name)
    lib = _LIBS.get(target)
    if lib is None:
        build_source(text, name)
        lib = _LIBS[target] = _bind(target, signatures)
    return lib
