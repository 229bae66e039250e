"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into the
git-ignored ``_build/`` directory of the package, and loaded with
``ctypes``.  The library's file name carries a hash of its source, so
an edited source is rebuilt and a stale library is never loaded.
Sources build in parallel: one ``nvcc`` process per source, all started
together.

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

__all__ = ["LAUNCHES", "reset_launches", "build", "load", "sources"]

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = collections.Counter()
_LIBS = {}


def reset_launches():
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()


def sources():
    """Kernel name -> source path, for every ``csrc/*.cu``."""
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
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


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
    todo = {n: srcs[n] for n in names if not _target(srcs[n]).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.monotonic()
    procs = {}
    for name, src in todo.items():
        tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built, failed = {}, {}
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed[name] = log
            continue
        os.replace(tmp, _target(todo[name]))
        built[name] = {"path": str(_target(todo[name])),
                       "seconds": time.monotonic() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{log}" for n, log in failed.items()))
    return built


def load(name, signatures):
    """The loaded library of kernel ``name``, built first if needed.
    ``signatures`` maps each C function to ``(argtypes, restype)``;
    pointers and streams must be ``c_void_p``, or ctypes cuts them to
    32 bits."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(sources()[name])))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib
