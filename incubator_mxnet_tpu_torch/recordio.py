"""RecordIO readers and writers (twin of
``incubator_mxnet_tpu/recordio.py``; ref: python/mxnet/recordio.py
MXRecordIO:36, MXIndexedRecordIO:170, IRHeader:291-316).

Two backends, one format (dmlc's, magic 0xced7230a), so a file written
by either backend, or by either package, reads back byte for byte in
the other:

- native: ``src/recordio/recordio.cc`` through ctypes, built with
  ``g++`` at first use into the package's ``_build/host/``
  (``utils/host_build.py``);
- Python (``struct``), always there, used where the library cannot be
  built.

``backend_name()`` says which one runs.  Host-side only: no torch.
"""
import ctypes
import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .utils import host_build

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img",
           "backend_name"]

_MAGIC = 0xced7230a

_SIGNATURES = {
    "rio_writer_open": ([ctypes.c_char_p, ctypes.c_int], ctypes.c_void_p),
    "rio_writer_write": ([ctypes.c_void_p, ctypes.c_char_p,
                          ctypes.c_uint64], ctypes.c_int64),
    "rio_writer_tell": ([ctypes.c_void_p], ctypes.c_int64),
    "rio_writer_close": ([ctypes.c_void_p], None),
    "rio_reader_open": ([ctypes.c_char_p], ctypes.c_void_p),
    "rio_reader_seek": ([ctypes.c_void_p, ctypes.c_int64], None),
    "rio_reader_tell": ([ctypes.c_void_p], ctypes.c_int64),
    "rio_reader_next": ([ctypes.c_void_p], ctypes.c_int64),
    "rio_reader_data": ([ctypes.c_void_p], ctypes.POINTER(ctypes.c_char)),
    "rio_reader_close": ([ctypes.c_void_p], None),
}


def _native_lib():
    """The native recordio library (built at first use), or None."""
    return host_build.load("recordio", _SIGNATURES)


def backend_name():
    """'native' when the C library is loaded, else 'python'."""
    return "native" if _native_lib() is not None else "python"


class MXRecordIO:
    """Sequential RecordIO reader/writer (ref: recordio.py:36)."""

    def __init__(self, uri, flag):
        if flag not in ("r", "w"):
            raise ValueError(f"flag must be 'r' or 'w', got {flag!r}")
        self.uri = uri
        self.flag = flag
        self._lib = _native_lib()
        self._handle = None
        self._fp = None
        self.open()

    # ------------------------------------------------------------ mgmt
    def open(self, append=False):
        self._pid = os.getpid()
        if self._lib is not None:
            if self.flag == "w":
                self._handle = self._lib.rio_writer_open(
                    self.uri.encode(), 1 if append else 0)
            else:
                self._handle = self._lib.rio_reader_open(
                    self.uri.encode())
            if not self._handle:
                raise IOError(f"cannot open {self.uri}")
        else:
            if self.flag == "w":
                self._fp = open(self.uri, "ab" if append else "wb")
            else:
                self._fp = open(self.uri, "rb")
        self.is_open = True

    def close(self):
        if not getattr(self, "is_open", False):
            return
        if self._lib is not None and self._handle:
            if self.flag == "w":
                self._lib.rio_writer_close(
                    ctypes.c_void_p(self._handle))
            else:
                self._lib.rio_reader_close(
                    ctypes.c_void_p(self._handle))
            self._handle = None
        if self._fp is not None:
            self._fp.close()
            self._fp = None
        self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass  # interpreter teardown: ctypes may already be gone

    def __getstate__(self):
        if getattr(self, "is_open", False) and self.flag == "w":
            # commit buffered writes before the state is captured:
            # the unpickled copy reopens the file in append mode, so
            # everything it is supposed to continue *after* must be
            # on disk now, not in this process's stdio buffer
            # (close+reopen-append flushes on both backends)
            self.close()
            self.open(append=True)
        # both copies of a pickled writer may eventually close();
        # mark them so index-carrying subclasses merge with the
        # on-disk index instead of overwriting the other copy's
        self._forked = True
        d = dict(self.__dict__)
        d["_handle"] = None
        d["_fp"] = None
        d["_lib"] = None
        is_open = d.pop("is_open", False)
        d["_was_open"] = is_open
        return d

    def __setstate__(self, d):
        was_open = d.pop("_was_open", False)
        self.__dict__.update(d)
        self._lib = _native_lib()
        self.is_open = False
        if was_open:
            # an unpickled writer must NOT reopen with "w" semantics:
            # that truncates the very file it was writing (fork-based
            # DataLoader workers pickle their dataset, which may hold
            # an open writer).  Append keeps the bytes already
            # committed; readers reopen normally at offset 0.
            self.open(append=self.flag == "w")

    def _need(self, flag):
        if self.flag != flag:
            raise IOError(f"{self.uri} is open with flag "
                          f"{self.flag!r}, this needs {flag!r}")
        if flag == "r" and self.is_open and self._pid != os.getpid():
            # a forked child (a DataLoader worker) shares the parent's
            # file offset: it opens a handle of its own, and leaves the
            # inherited one unclosed, since closing a read stream moves
            # the offset that the parent shares
            self._inherited = (self._handle, self._fp)
            self._handle = self._fp = None
            self.is_open = False
            self.open()

    # ------------------------------------------------------------ io
    def write(self, buf):
        self._need("w")
        if self._lib is not None:
            n = self._lib.rio_writer_write(
                ctypes.c_void_p(self._handle), buf, len(buf))
            if n < 0:
                raise IOError("recordio write failed")
        else:
            self._py_write(buf)

    def read(self):
        self._need("r")
        if self._lib is not None:
            n = self._lib.rio_reader_next(ctypes.c_void_p(self._handle))
            if n == -1:
                buf = None  # EOF
            elif n < 0:
                raise IOError(
                    "corrupt recordio stream in "
                    f"{self.uri} near offset {self.tell()} "
                    "(bad magic or truncated record)")
            else:
                data = self._lib.rio_reader_data(
                    ctypes.c_void_p(self._handle))
                buf = ctypes.string_at(data, n)
        else:
            buf = self._py_read()
        return self._maybe_inject(buf)

    def _maybe_inject(self, buf):
        """``record:read`` fault point: deterministically corrupt or
        truncate the record payload a test asked for (kind ``error``
        raises inside inject) — the CPU-testable stand-in for disk
        bit-rot under a record iterator."""
        from .resilience import faults_active, inject
        if buf is None or not faults_active():
            return buf
        kind = inject("record", "read")
        if kind == "corrupt":
            first = buf[0] ^ 0xFF if buf else 0xFF
            return bytes([first]) + buf[1:]
        if kind == "truncate":
            return buf[:len(buf) // 2]
        return buf

    def tell(self):
        if self.flag == "r":
            self._need("r")
        if self._lib is not None:
            f = self._lib.rio_writer_tell if self.flag == "w" \
                else self._lib.rio_reader_tell
            return f(ctypes.c_void_p(self._handle))
        return self._fp.tell()

    # -------------------------------------------------- python backend
    _MAGIC_BYTES = struct.pack("<I", _MAGIC)

    def _py_write(self, buf):
        # split at embedded magics exactly like the native writer
        chunks = []
        start = 0
        while True:
            hit = buf.find(self._MAGIC_BYTES, start)
            if hit < 0:
                chunks.append(buf[start:])
                break
            chunks.append(buf[start:hit])
            start = hit + 4
        for i, chunk in enumerate(chunks):
            if len(chunks) == 1:
                cflag = 0
            elif i == 0:
                cflag = 1
            elif i == len(chunks) - 1:
                cflag = 3
            else:
                cflag = 2
            lrec = (cflag << 29) | len(chunk)
            self._fp.write(struct.pack("<II", _MAGIC, lrec))
            self._fp.write(chunk)
            pad = (4 - (len(chunk) & 3)) & 3
            if pad:
                self._fp.write(b"\x00" * pad)

    def _py_read(self):
        out = b""
        in_split = False
        read_any = False
        while True:
            at = self._fp.tell()
            hdr = self._fp.read(8)
            if len(hdr) < 8:
                if read_any:
                    raise IOError(
                        "corrupt recordio stream in "
                        f"{self.uri} near offset {at} "
                        "(truncated record header)")
                return None
            read_any = True
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _MAGIC:
                raise IOError(
                    "corrupt recordio stream in "
                    f"{self.uri} near offset {at} (bad magic "
                    f"0x{magic:08x})")
            length = lrec & ((1 << 29) - 1)
            cflag = lrec >> 29
            if in_split:
                out += self._MAGIC_BYTES
            chunk = self._fp.read(length)
            if len(chunk) < length:
                # a declared length past EOF: validate instead of
                # silently returning a short record
                raise IOError(
                    "corrupt recordio stream in "
                    f"{self.uri} near offset {at} (record claims "
                    f"{length} bytes, only {len(chunk)} on disk)")
            out += chunk
            pad = (4 - (length & 3)) & 3
            if pad:
                self._fp.read(pad)
            if cflag in (0, 3):
                return out
            in_split = True

    def resync(self, max_scan=1 << 26):
        """After a corrupt :meth:`read`: scan forward from the
        current position for the next record magic and seat the
        stream there, so a record-backed iterator can quarantine the
        bad region and keep going (the dmlc scan-for-magic recovery).
        Returns the new offset, or None when no further magic exists
        within ``max_scan`` bytes.  Each failed read consumes at
        least its header bytes, so alternating read()/resync() always
        makes forward progress."""
        self._need("r")
        pos = self.tell()
        with open(self.uri, "rb") as f:
            f.seek(pos)
            buf = b""
            while f.tell() - pos <= max_scan:
                chunk = f.read(1 << 16)
                if not chunk:
                    return None
                buf = buf[-3:] + chunk  # keep the chunk-seam bytes
                hit = buf.find(self._MAGIC_BYTES)
                if hit >= 0:
                    new_pos = f.tell() - len(buf) + hit
                    self.seek(new_pos)
                    return new_pos
        return None

    def seek(self, pos):
        self._need("r")
        if self._lib is not None:
            self._lib.rio_reader_seek(ctypes.c_void_p(self._handle),
                                      pos)
        else:
            self._fp.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO with a position index for random access (ref:
    recordio.py:170; idx format: 'key\\tpos\\n' like tools/rec2idx)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        k = key_type(parts[0])
                        self.idx[k] = int(parts[1])
                        self.keys.append(k)

    def close(self):
        if getattr(self, "flag", None) == "w" and \
                getattr(self, "is_open", False):
            entries = dict(self.idx)
            if getattr(self, "_forked", False) and \
                    os.path.exists(self.idx_path):
                # this writer crossed a pickle boundary: the other
                # copy may have closed first — union with its index
                # (ours wins on conflict) so neither close clobbers
                # the other's records
                with open(self.idx_path) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) == 2:
                            k = self.key_type(parts[0])
                            entries.setdefault(k, int(parts[1]))
            order = sorted(entries, key=lambda k: entries[k]) \
                if getattr(self, "_forked", False) else self.keys
            with open(self.idx_path, "w") as f:
                for k in order:
                    f.write(f"{k}\t{entries[k]}\n")
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        pos = self.tell()
        self.write(buf)
        self.idx[idx] = pos
        self.keys.append(idx)


# ---------------------------------------------------------------------------
# image-record packing (ref: recordio.py IRHeader:291, pack:316,
# pack_img/unpack_img)
# ---------------------------------------------------------------------------

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Serialize header + payload (ref: recordio.py pack).  flag is
    derived from the label (0 = scalar, else element count) because
    unpack interprets it as the label count."""
    label = header.label
    if isinstance(label, numbers.Number):
        hdr = struct.pack(_IR_FORMAT, 0, float(label), header.id,
                          header.id2)
    else:
        label = np.asarray(label, np.float32).reshape(-1)
        hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                          header.id2)
        s = label.tobytes() + s
    return hdr + s


def unpack(s):
    """Deserialize into (IRHeader, payload)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode image array + header (ref: recordio.py pack_img)."""
    import io as _io
    from PIL import Image
    arr = np.asarray(img).astype(np.uint8)
    buf = _io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    Image.fromarray(arr).save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """Decode to (IRHeader, HxWxC uint8 array)."""
    import io as _io
    from PIL import Image
    header, img_bytes = unpack(s)
    img = Image.open(_io.BytesIO(img_bytes))
    if iscolor == 0:
        img = img.convert("L")
    elif iscolor == 1 or img.mode != "RGB":
        img = img.convert("RGB")
    return header, np.asarray(img)
