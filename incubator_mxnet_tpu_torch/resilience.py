"""Atomic, checksummed files and the typed errors the serving engine
raises (a part of ``incubator_mxnet_tpu/resilience.py``).

Only what the serving engine's snapshots and deadlines and the
checkpoints (``nd.save``/``nd.load``, ``model``, ``Module``) need is
here: ``atomic_save`` writes a file through a same-directory temp file,
fsync and rename, with a CRC32 sidecar (``path.crc32``: "crc32hex
size"); ``read_validated_bytes`` reads it back against that sidecar,
``validate_or_raise`` checks a file against it by a streamed pass, and
``decode_or_corrupt`` turns a failed decode into
``CheckpointCorruptError``.  The sidecar format is the JAX package's,
so a file written by either package validates in the other.

The input pipeline (``io``, ``image``, ``gluon.data``) raises
``DataPipelineError`` and reads its flags through ``data_env``: the
JAX package's defaults for ``MXTPU_DATA_TIMEOUT``,
``MXTPU_MAX_BAD_RECORDS``, ``MXTPU_DEVICE_PREFETCH_DEPTH``,
``MXTPU_DL_DEAD_GRACE``, ``MXTPU_DATA_WORKER_RESTARTS`` and
``MXTPU_NATIVE_DECODE`` (``utils/env.py`` there, ROADMAP item A11
here).

Not in this slice: retry policies, deadline calls, fault injection
(``MXTPU_FAULT_SPEC``), heartbeats and the numeric guard.
"""
import os
import tempfile
import zlib

from .engine import get_env

__all__ = ["ResilienceError", "DeadlineExceededError",
           "CheckpointCorruptError", "DataPipelineError", "data_env",
           "data_timeout", "checksum_path", "atomic_save",
           "read_validated_bytes", "validate_or_raise",
           "decode_or_corrupt"]


class ResilienceError(RuntimeError):
    """Base class for resilience-layer failures."""


class DeadlineExceededError(ResilienceError):
    """An operation ran past its wall-clock deadline."""


class CheckpointCorruptError(ResilienceError, IOError):
    """A checkpoint file failed checksum / decode validation.

    Subclasses IOError so legacy ``except IOError`` checkpoint
    handling still catches it."""


class DataPipelineError(ResilienceError):
    """The input pipeline failed as a pipeline: a prefetch worker
    raised or wedged, a DataLoader process died past its restart
    budget, or a record source exceeded its bad-record budget.  Typed
    so a training loop can tell "the data stopped" from a model
    failure; a RuntimeError too, through ResilienceError."""


# the input pipeline's flags and their defaults, as the JAX package
# registers them (incubator_mxnet_tpu/utils/env.py)
_DATA_ENV = {
    "MXTPU_DATA_TIMEOUT": (float, 600.0),
    "MXTPU_DATA_WORKER_RESTARTS": (int, 2),
    "MXTPU_MAX_BAD_RECORDS": (int, 0),
    "MXTPU_DL_DEAD_GRACE": (float, 60.0),
    "MXTPU_DEVICE_PREFETCH_DEPTH": (int, 2),
    "MXTPU_NATIVE_DECODE": (str, "1"),
}


def data_env(name):
    """Input-pipeline flag ``name`` parsed as the JAX package's
    registry parses it: a missing or unparsable value gives the
    default."""
    type_, default = _DATA_ENV[name]
    raw = get_env(name)
    if raw is None:
        return default
    try:
        return type_(raw)
    except ValueError:
        return default


def data_timeout():
    """Deadline in seconds on input-pipeline queue waits
    (``MXTPU_DATA_TIMEOUT``; 0 disables): a wedged producer surfaces
    as a ``DataPipelineError`` naming its source."""
    return data_env("MXTPU_DATA_TIMEOUT")


def checksum_path(path):
    """Sidecar path holding "crc32_hex size" for ``path``."""
    return path + ".crc32"


def _read_sidecar(side):
    """Parse a sidecar file ("crc32hex size") -> (crc, size).
    Raises ValueError/OSError on a malformed or unreadable one."""
    with open(side, "rb") as f:
        want_crc, want_size = f.read().split()
    return int(want_crc, 16), int(want_size)


def _file_crc(path):
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc & 0xFFFFFFFF, size


def _write_tmp(path, writer):
    """``writer(fileobj)`` into a same-directory fsynced temp file;
    returns the temp path (cleaned up on writer failure)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        os.unlink(tmp)
        raise
    return tmp


def _fsync_dir(path):
    """fsync the directory holding ``path`` so a just-committed
    rename/unlink survives power loss, not only process death.  Some
    filesystems refuse dir fsync — then rename ordering is all we
    get, which still covers every process-crash point."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _replace_with_bytes(path, data):
    """Write ``data`` to ``path`` via temp + fsync + rename + dir
    fsync."""
    tmp = _write_tmp(path, lambda f: f.write(data))
    try:
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    _fsync_dir(path)


def atomic_save(path, writer):
    """Atomically write a checkpoint: ``writer(fileobj)`` produces
    the payload into a same-directory temp file, which is fsynced and
    renamed over ``path`` only once complete — a concurrent reader
    sees either the old file or the new one, never a torn write.  The
    stale CRC32+size sidecar (``path.crc32``) is removed *before* the
    data rename and the fresh one written right after, so no crash
    point pairs a data file with a mismatched sidecar: a crash before
    the data rename leaves the old data sidecar-less but intact, one
    between rename and sidecar write leaves the new data sidecar-less
    but complete — both load, since a missing sidecar passes
    validation.  The containing directory is fsynced after the data
    rename, so the same holds across power loss."""
    tmp = _write_tmp(path, writer)
    try:
        crc, size = _file_crc(tmp)
        try:
            os.unlink(checksum_path(path))
        except FileNotFoundError:
            pass
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    # commit the unlink+rename before the new sidecar can land: a
    # power loss must never resurrect the old sidecar next to the
    # new data (= spurious CRC veto on a complete file)
    _fsync_dir(path)
    _replace_with_bytes(checksum_path(path),
                        f"{crc:08x} {size}\n".encode())


def validate_or_raise(path):
    """Raise ``CheckpointCorruptError`` when ``path`` does not match its
    CRC32 sidecar (a missing sidecar passes).  The CRC is streamed, so a
    large file is never held whole; a mismatch is checked once more, as
    a concurrent ``atomic_save`` may have paired old bytes with its new
    sidecar."""
    side = checksum_path(path)
    for _ in (0, 1):
        if not os.path.exists(side):
            return
        try:
            want = _read_sidecar(side)
            if _file_crc(path) == want:
                return
        except (ValueError, OSError):
            pass
    raise CheckpointCorruptError(
        f"checkpoint {path} failed CRC32 validation "
        f"(truncated or corrupt; sidecar {side})")


def read_validated_bytes(path):
    """Read ``path`` once and validate the bytes against the CRC32
    sidecar when one exists (a missing sidecar passes).

    A mismatch is re-read once before being declared corruption: a
    concurrent atomic_save can land its rename between our data read
    and sidecar read, pairing old bytes with the new sidecar — the
    second read sees a settled pair, so a real corruption still
    raises and a mid-save race never vetoes a healthy file."""
    for _ in (0, 1):
        with open(path, "rb") as f:
            data = f.read()
        side = checksum_path(path)
        if not os.path.exists(side):
            return data
        try:
            want_crc, want_size = _read_sidecar(side)
            ok = (zlib.crc32(data) & 0xFFFFFFFF) == want_crc \
                and len(data) == want_size
        except (ValueError, OSError):
            ok = False
        if ok:
            return data
    raise CheckpointCorruptError(
        f"checkpoint {path} failed CRC32 validation "
        f"(truncated or corrupt; sidecar {checksum_path(path)})")


def decode_or_corrupt(fname, fn):
    """Run a *pure decode* step ``fn()`` (pickle.loads, archive
    parse — no application side effects), mapping any failure to
    :class:`CheckpointCorruptError`.  A corrupt pickle stream can
    raise nearly anything (UnpicklingError, EOFError, AttributeError,
    ImportError, KeyError…), which is why ``fn`` must not also
    *apply* the payload: an error from applying a well-formed object
    is not corruption and must stay loud."""
    try:
        return fn()
    except ResilienceError:
        raise
    except Exception as exc:
        raise CheckpointCorruptError(
            f"checkpoint {fname} failed to decode ({exc}); "
            "truncated or corrupt") from exc
