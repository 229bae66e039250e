"""Host-platform pinning and the build cache for entry points (twin of
``incubator_mxnet_tpu/utils/platform.py``).

``MXTPU_FORCE_CPU=1`` is the caller's explicit request to run on the
host: :func:`maybe_force_cpu` makes ``cpu()`` the port's default context
(``context.pin_default``), which every entry point called without a
device then takes.  It is not a fallback: unset, nothing changes, and an
entry point called without a device on a host without a card still
raises.  Once CUDA is initialized the pin can no longer keep a process
off the card, so the call warns and returns False.

:func:`enable_compile_cache` points the port's build directories, the
nvcc libraries of ``ops/_build.py`` (kernels and ``rtc`` sources) and
the g++ libraries of ``utils/host_build.py``, at one directory that
outlives a run, so a killed run keeps what it built: the role the JAX
function's persistent XLA cache plays for compiled executables.
"""
import os
import warnings
from pathlib import Path

__all__ = ["maybe_force_cpu", "enable_compile_cache"]

_REPO = Path(__file__).resolve().parent.parent.parent


def _ignored_dirs():
    """The directory patterns the repository's ``.gitignore`` lists
    (relative, without the trailing slash)."""
    try:
        lines = (_REPO / ".gitignore").read_text().splitlines()
    except OSError:
        return []
    return [ln.strip().strip("/") for ln in lines
            if ln.strip().endswith("/") and "*" not in ln]


def enable_compile_cache(path=None):
    """Point the nvcc and g++ build directories at ``path`` (default
    ``$MXTPU_COMPILE_CACHE``, else ``~/.cache/mxtpu-torch-build``):
    kernels go to ``path/cuda``, ``rtc`` sources to ``path/cuda/rtc``,
    host libraries to ``path/host``.  A path inside the repository must
    lie under a directory ``.gitignore`` lists (ValueError otherwise),
    so no build output is ever committed.  Returns True."""
    from ..ops import _build
    from . import host_build
    root = Path(path or os.environ.get("MXTPU_COMPILE_CACHE")
                or os.path.expanduser("~/.cache/mxtpu-torch-build"))
    root = root.resolve()
    try:
        rel = root.relative_to(_REPO)
    except ValueError:
        rel = None
    if rel is not None and not any(
            rel.parts[:len(Path(d).parts)] == Path(d).parts
            for d in _ignored_dirs()):
        raise ValueError(
            f"compile cache {root} lies inside the repository but under "
            "no directory .gitignore lists")
    (root / "cuda" / "rtc").mkdir(parents=True, exist_ok=True)
    (root / "host").mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = root / "cuda"
    _build.RTC_DIR = root / "cuda" / "rtc"
    host_build.BUILD_DIR = root / "host"
    return True


def maybe_force_cpu():
    """True iff the CPU pin is in effect.  ``MXTPU_FORCE_CPU`` unset,
    '0', 'false' or 'no' leaves everything as it is (False); set, it
    pins ``cpu()`` as the default context, unless CUDA is initialized
    already, when it warns and returns False."""
    flag = os.environ.get("MXTPU_FORCE_CPU", "").lower()
    if flag in ("", "0", "false", "no"):
        return False
    import torch

    from .. import context
    if torch.cuda.is_initialized():
        warnings.warn(
            "MXTPU_FORCE_CPU set, but CUDA is initialized already — the "
            "CPU pin cannot take effect; call maybe_force_cpu() before "
            "any CUDA use", stacklevel=2)
        return False
    context.pin_default(context.cpu())
    return True
