"""Build the host-side C++ libraries of the input pipeline.

``src/recordio/recordio.cc`` (the RecordIO reader and writer) and
``src/imgdec/imgdec.cc`` (the batch JPEG decoder, on libjpeg) are
compiled with ``g++`` at first use into the package's git-ignored
``_build/host/`` directory and loaded with ``ctypes``.  A library's
file name carries a hash of its source, so an edited source is rebuilt
and a stale library is never loaded; the compiler writes a temporary
file that is renamed into place, so two processes building at once
never load a half-written one.

``load`` returns None when the library cannot be built on this host
(no ``g++``, no ``jpeglib.h``), and ``why(name)`` then says why: the
callers fall back to their Python paths and name the cause in their
errors.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "load", "why"]

REPO = Path(__file__).resolve().parent.parent.parent
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "host"

# name -> (source, extra link flags)
SOURCES = {
    "recordio": (REPO / "src" / "recordio" / "recordio.cc", []),
    "imgdec": (REPO / "src" / "imgdec" / "imgdec.cc",
               ["-ljpeg", "-lpthread"]),
}

_LIBS = {}
_WHY = {}
_LOCK = threading.Lock()


def _target(src):
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def _compile(src, target, libs):
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o",
             str(tmp), str(src), *libs],
            capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"g++ could not run: {exc}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = (proc.stderr or proc.stdout).strip().splitlines()
        return lines[0] if lines else "g++ failed"
    os.replace(tmp, target)
    return None


def load(name, signatures):
    """The loaded library ``name`` (a key of ``SOURCES``), built first
    if needed, with ``signatures`` ``{fn: (argtypes, restype)}`` set;
    None when it cannot be built or loaded here (``why(name)``)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src, libs = SOURCES[name]
        lib = None
        if not src.exists():
            _WHY[name] = f"{src} is missing"
        else:
            target = _target(src)
            err = None if target.exists() else _compile(src, target, libs)
            if err is not None:
                _WHY[name] = err
            else:
                try:
                    lib = ctypes.CDLL(str(target))
                    for fn, (argtypes, restype) in signatures.items():
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = restype
                except (OSError, AttributeError) as exc:
                    lib = None
                    _WHY[name] = f"{target} did not load: {exc}"
        _LIBS[name] = lib
        return lib


def why(name):
    """Why library ``name`` is not loaded (None if it is, or was never
    asked for)."""
    return _WHY.get(name)
