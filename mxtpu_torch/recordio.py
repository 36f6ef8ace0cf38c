"""RecordIO: MXNet's packed binary record format.

Counterpart of ``mxtpu/recordio.py``, and byte-compatible with it: a file
written by either package is read by the other. ``MXRecordIO`` is the
sequential reader/writer (picklable: a spawned decode worker reopens the
file), ``MXIndexedRecordIO`` adds a ``.idx`` file of "key\\toffset" lines
for random access, ``IRHeader`` with ``pack``/``unpack`` frames (label,
id) image records, and ``pack_img``/``unpack_img`` encode and decode
images through PIL.

Binary layout (dmlc-core's recordio): ``[kMagic u32][lrec u32][data][pad
to 4B]``, where lrec's upper 3 bits are the continuation flag (0 = whole
record) and its lower 29 bits the length. The module imports numpy and
PIL only.
"""
from __future__ import annotations

import io
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_KMAGIC = 0xCED7230A
_LSHIFT = 29
_LMASK = (1 << _LSHIFT) - 1


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference recordio.py:MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("handle", None)
        return d

    def __setstate__(self, d):
        self.__dict__ = d
        is_open = d.get("is_open", False)
        self.is_open = False
        self.handle = None
        if is_open:
            self.open()

    def _check_pid(self, allow_reset=False):
        # after fork (DataLoader workers) reopen the file in the child
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
                self.pid = os.getpid()
            else:
                raise RuntimeError("forked process must call reset() first")

    def close(self):
        if self.is_open and self.handle is not None:
            if self.writable:
                # durability: close() is the commit point — flush alone
                # leaves records in the page cache, where a host crash
                # right after "successful" close loses them (a writer
                # that dies BEFORE close is the reader's torn-tail
                # contract instead)
                self.handle.flush()
                os.fsync(self.handle.fileno())
            self.handle.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def write(self, buf):
        assert self.writable
        self._check_pid(allow_reset=False)
        if len(buf) > _LMASK:
            raise ValueError("record too large (%d bytes)" % len(buf))
        self.handle.write(struct.pack("<II", _KMAGIC, len(buf)))
        self.handle.write(buf)
        pad = (4 - (len(buf) & 3)) & 3
        if pad:
            self.handle.write(b"\x00" * pad)

    def seek(self, pos):
        """Seek the reader to a byte offset previously returned by
        ``tell`` (reference MXRecordIOReaderSeek)."""
        assert not self.writable, "seek is a reader operation"
        self.handle.seek(int(pos))

    def tell(self):
        return self.handle.tell()

    def read(self):
        assert not self.writable
        self._check_pid(allow_reset=True)
        head = self.handle.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _KMAGIC:
            raise IOError("invalid RecordIO magic at offset %d"
                          % (self.handle.tell() - 8))
        length = lrec & _LMASK
        data = self.handle.read(length)
        if len(data) < length:
            # torn tail: a SIGKILL'd writer died mid-record. Every
            # frame before this one is intact — report clean EOF (the
            # cursor rewinds to the torn frame, so tell() names where
            # the valid prefix ends) instead of handing out a partial
            # payload as if it were a record.
            self.handle.seek(-(8 + len(data)), os.SEEK_CUR)
            return None
        pad = (4 - (length & 3)) & 3
        if pad:
            self.handle.read(pad)
        return data


class MXIndexedRecordIO(MXRecordIO):
    """Random-access RecordIO via a `.idx` file of "key\\toffset" lines
    (reference MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and os.path.isfile(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        assert not self.writable
        self._check_pid(allow_reset=True)
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + raw bytes into one record (reference pack).
    ``header.flag > 0`` means ``label`` is an array of that many floats."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                          header.id2) + label.tobytes()
    return hdr + s


def unpack(s):
    """Unpack a record into (IRHeader, payload bytes) (reference unpack)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[: header.flag * 4], np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def _require_pil():
    try:
        from PIL import Image
        return Image
    except ImportError as e:
        raise ImportError(
            "pack_img/unpack_img need Pillow (reference uses OpenCV); "
            "install PIL or use pack/unpack with raw bytes") from e


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an image array and pack it (reference pack_img)."""
    Image = _require_pil()
    arr = np.asarray(img).astype(np.uint8)
    pil = Image.fromarray(arr)
    buf = io.BytesIO()
    fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
    pil.save(buf, format=fmt, quality=quality)
    return pack(header, buf.getvalue())


def unpack_img(s, iscolor=-1):
    """Unpack a record and decode its image (reference unpack_img)."""
    Image = _require_pil()
    header, img_bytes = unpack(s)
    pil = Image.open(io.BytesIO(img_bytes))
    if iscolor == 0:
        pil = pil.convert("L")
    elif iscolor == 1:
        pil = pil.convert("RGB")
    return header, np.asarray(pil)
