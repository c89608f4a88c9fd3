"""RecordIO of the PyTorch port (a copy of incubator_mxnet_tpu/io/recordio.py;
ref: dmlc-core's recordio.h and python/mxnet/recordio.py).

The dmlc RecordIO framing, byte for byte, so that a .rec file written by
either package, or by MXNet's tools/im2rec.py, reads the same in the
other:

  each record:  u32 magic (0xced7230a)
                u32 lrecord = (cflag << 29) | length
                payload bytes, zero-padded to a 4-byte boundary
  cflag: 0 = whole record, 1/2/3 = begin/middle/end of a split record.

IRHeader packs (flag, label, id, id2) little-endian as MXNet's
image-record header; a multi-label record carries its float labels after
it (flag = their count).  `pack_img` encodes with PIL (JPEG or PNG), or
into the raw ``RAWI`` frame where PIL is missing.  The ``.idx`` sidecar
maps keys to offsets and the ``.crc`` sidecar holds a CRC per payload
(`write_crc_sidecar`).  numpy and the standard library only: the decode
service's worker processes run this module.
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as _np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img", "read_record",
           "list_record_offsets", "idx_sidecar_path",
           "crc_sidecar_path", "write_crc_sidecar", "read_crc_sidecar"]

_MAGIC = 0xced7230a
_CFLAG_BITS = 29
_LEN_MASK = (1 << _CFLAG_BITS) - 1


def read_record(fh):
    """Read one framed record from a binary file object positioned at a
    record boundary; returns the payload bytes, or None at EOF.  The
    standalone framing parser — `MXRecordIO.read` adds the fault hooks
    on top, and decode-service workers call this directly on their own
    file handles (no shared state, no fault registry)."""
    header = fh.read(8)
    if len(header) < 8:
        return None
    magic, lrec = struct.unpack("<II", header)
    if magic != _MAGIC:
        raise IOError("invalid RecordIO magic at offset %d"
                      % (fh.tell() - 8))
    cflag = lrec >> _CFLAG_BITS
    length = lrec & _LEN_MASK
    buf = fh.read(length)
    fh.read((-length) % 4)
    if cflag == 0:
        return buf
    # split record: keep reading continuation chunks
    parts = [buf]
    while cflag not in (0, 3):
        header = fh.read(8)
        if len(header) < 8:
            raise IOError("truncated RecordIO: EOF inside a split "
                          "record at offset %d"
                          % (fh.tell() - len(header)))
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise IOError("invalid RecordIO magic at offset %d"
                          % (fh.tell() - 8))
        cflag = lrec >> _CFLAG_BITS
        length = lrec & _LEN_MASK
        parts.append(fh.read(length))
        fh.read((-length) % 4)
    return b"".join(parts)


def list_record_offsets(uri):
    """Byte offset of every record in a .rec file, in file order — the
    non-indexed analogue of the .idx sidecar.  One sequential header
    scan (payloads are seek()ed over, not read), so sharded readers
    (io.decode_service) can partition a plain .rec keyspace exactly the
    way an indexed one partitions its keys.  Continuation chunks of a
    split record do not get their own offset."""
    offsets = []
    with open(uri, "rb") as fh:
        while True:
            pos = fh.tell()
            header = fh.read(8)
            if len(header) < 8:
                break
            magic, lrec = struct.unpack("<II", header)
            if magic != _MAGIC:
                raise IOError("invalid RecordIO magic at offset %d" % pos)
            cflag = lrec >> _CFLAG_BITS
            length = lrec & _LEN_MASK
            fh.seek(length + ((-length) % 4), 1)
            if cflag in (0, 1):     # whole record, or head of a split
                offsets.append(pos)
    return offsets


def idx_sidecar_path(uri):
    """Path of the .idx sidecar for a .rec file: the extension swapped
    for '.idx', or appended when the file has none ('/data/train' →
    '/data/train.idx' — a bare rfind('.') would corrupt the name, or
    match a dot in a parent directory)."""
    base, ext = os.path.splitext(uri)
    return (base if ext else uri) + ".idx"


def crc_sidecar_path(uri):
    """Path of the ``.crc`` integrity sidecar for a .rec file —
    ``<uri>.crc`` verbatim (no extension swap: the sidecar names the
    exact file it covers, and a ``train.rec`` / ``train.idx`` pair
    must not collide with ``train.crc`` meaning either)."""
    return str(uri) + ".crc"


def write_crc_sidecar(uri, offsets=None):
    """Write the per-record CRC sidecar for a .rec file: one
    ``offset<TAB>crc`` line per record over the PAYLOAD bytes
    (what `read_record` returns — framing headers and padding are
    already covered by the magic check), headed by an ``#algo=`` line
    naming the checksum in use (`integrity.checksum_algo`).  Readers
    with the sidecar present verify each payload and QUARANTINE
    mismatches instead of decoding garbage pixels.  Returns the
    sidecar path."""
    from ..integrity import checksum, checksum_algo
    if offsets is None:
        offsets = list_record_offsets(uri)
    path = crc_sidecar_path(uri)
    tmp = path + ".tmp"
    with open(uri, "rb") as fh, open(tmp, "w") as out:
        out.write("#algo=%s\n" % checksum_algo())
        for off in offsets:
            fh.seek(int(off))
            payload = read_record(fh)
            if payload is None:
                raise IOError("EOF at offset %d while writing CRC "
                              "sidecar for %s" % (off, uri))
            out.write("%d\t%d\n" % (int(off), checksum(payload)))
    os.replace(tmp, path)
    return path


def read_crc_sidecar(uri):
    """Load a ``.crc`` sidecar: ``(algo, {offset: crc})``, or ``None``
    when the file has none (verification simply stays off).  A
    malformed sidecar raises IOError — half a safety net is worse
    than none."""
    path = crc_sidecar_path(uri)
    if not os.path.isfile(path):
        return None
    algo = None
    crcs = {}
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("#"):
                    if line.startswith("#algo="):
                        algo = line[len("#algo="):]
                    continue
                off, crc = line.split("\t")
                crcs[int(off)] = int(crc)
    except (ValueError, OSError) as e:
        raise IOError("malformed CRC sidecar %s: %s" % (path, e)) from e
    if algo is None:
        raise IOError("CRC sidecar %s missing the #algo= header" % path)
    return algo, crcs


class MXRecordIO:
    """ref: mx.recordio.MXRecordIO — sequential read/write."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.handle = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.handle = open(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("flag must be 'r' or 'w'")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["handle"] = None
        d["is_open"] = False
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def write(self, buf):
        assert self.writable
        length = len(buf)
        self.handle.write(struct.pack("<II", _MAGIC, length & _LEN_MASK))
        self.handle.write(buf)
        pad = (-length) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def tell(self):
        return self.handle.tell()

    def read(self):
        assert not self.writable
        from .. import fault
        fault.maybe_slow("io.slow")
        fault.maybe_raise("io.read", exc_type=fault.InjectedIOError)
        return read_record(self.handle)

    def read_at(self, offset):
        """Seek to a byte offset (from `list_record_offsets` or an .idx
        entry) and read the record there."""
        self.handle.seek(offset)
        return self.read()


class MXIndexedRecordIO(MXRecordIO):
    """ref: mx.recordio.MXIndexedRecordIO — .idx 'key\\toffset' sidecar."""

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
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
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


IndexedRecordIO = MXIndexedRecordIO

IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """ref: mx.recordio.pack — IRHeader + payload. Multi-label goes as a
    float vector after the header (flag = label count)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = _np.asarray(header.label, dtype=_np.float32)
        hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id,
                          header.id2) + label.tobytes()
    return hdr + s


def unpack(s):
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = _np.frombuffer(s[:flag * 4], dtype=_np.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, id_, id2)
    return header, s


def _encode_img(img, fmt=".jpg", quality=95):
    try:
        from PIL import Image
        import io as _io
        if hasattr(img, "asnumpy"):
            img = img.asnumpy()
        im = Image.fromarray(_np.asarray(img).astype(_np.uint8))
        buf = _io.BytesIO()
        im.save(buf, format="JPEG" if fmt in (".jpg", ".jpeg") else "PNG",
                quality=quality)
        return buf.getvalue()
    except ImportError:
        # raw fallback: shape-prefixed uncompressed (decoder detects magic)
        a = _np.asarray(img).astype(_np.uint8)
        return b"RAWI" + struct.pack("<III", *(
            a.shape if a.ndim == 3 else a.shape + (1,))) + a.tobytes()


def _decode_img(buf, flag=1):
    if buf[:4] == b"RAWI":
        h, w, c = struct.unpack("<III", buf[4:16])
        return _np.frombuffer(buf[16:], dtype=_np.uint8).reshape(h, w, c)
    try:
        from PIL import Image
        import io as _io
        im = Image.open(_io.BytesIO(buf))
        if flag == 0:
            im = im.convert("L")
            return _np.asarray(im)[:, :, None]
        im = im.convert("RGB")
        return _np.asarray(im)
    except ImportError:
        raise IOError("cannot decode image: PIL unavailable and payload "
                      "is not RAWI-framed")


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """ref: mx.recordio.pack_img."""
    return pack(header, _encode_img(img, img_fmt, quality))


def unpack_img(s, iscolor=1):
    header, buf = unpack(s)
    return header, _decode_img(buf, flag=iscolor)
