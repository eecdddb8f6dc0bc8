"""A self-contained writer and reader for the subset of HDF5 that the
solver's output schema uses.

The machine that runs the port has no ``h5py``, so the port writes and
reads its output files through this module, with one code path on every
machine. The API is shaped like h5py's, so that ``to_hdf5``/``from_hdf5``
methods written against h5py run on it unchanged: :class:`File` (modes
``"r"``, ``"r+"``, ``"w"``, ``"x"``), :class:`Group` (``create_group``,
``require_group``, item get/set/delete with ``/`` paths, ``keys``,
``values``, ``items``), :class:`Dataset` (``np.asarray(ds)``, ``ds[()]``,
``ds[:]``, ``shape``, ``dtype``) and ``attrs`` mappings.

What it writes (HDF5 file format specification 3.0):

* superblock version 2 and version-2 object headers (``OHDR``), both with
  Jenkins lookup3 checksums, one chunk per header;
* groups with compact link storage (Link Info, Group Info and Link
  messages); ``track_order=True`` records each link's creation order;
* datasets with contiguous layout and no filters, attributes as compact
  Attribute messages (version 3, UTF-8 names);
* types: little-endian IEEE float32/float64, signed and unsigned
  integers, complex64/complex128 as h5py's compound ``{r, i}``, ``bool``
  as h5py's int8 enum (FALSE=0, TRUE=1), ``str`` as variable-length UTF-8
  strings in a global heap, and ``np.void`` as opaque data.

Write order: array data is written when its dataset is created, and
never moves; :meth:`Dataset.__setitem__` overwrites it whole, in place. Object headers and global heap collections are written
at :meth:`File.flush`/:meth:`File.close`, each changed header to a new
place (its ancestors follow, since their links change), and the
superblock last. So the file as last flushed stays readable if the
process dies. Space freed by a deletion (a replaced group's headers and
data) is reused after the next flush, when no flushed header refers to it
any more: a group that is replaced at every flush with arrays of the same
sizes costs two copies of its size in the file, not one per flush. A file
whose datasets are only overwritten in place after a flush keeps its
headers and superblock where they are, and reuses no block, so a reader
that opens it anew at any time finds every header it follows intact (a
dataset being overwritten may read half old and half new: data blocks
carry no checksum). The solver's ``<file>.h5.tmp`` side file, which the
live monitor polls, is written so.

What it reads: every file it writes, and the files h5py writes in HDF5's
default (earliest) format, as ``tdgl_tpu`` writes its output: superblock
version 0 or 1, version-1 object headers with continuation blocks beside
version-2 ones, symbol-table groups (a version-1 group B-tree of any
depth over symbol-table nodes, with names in a local heap), groups that
track creation order with compact or dense link storage (a fractal heap
indexed by a version-2 B-tree), dataspaces of version 1 and 2, attribute
messages of versions 1 to 3, contiguous and compact layouts, compound
and enum types of versions 1 to 3, and variable-length strings in global
heaps. Files in HDF5's default format are read only: ``"r+"`` on one
raises ``OSError``. Chunked or filtered datasets, external storage,
dense attribute storage, committed (shared) datatypes, and types other
than those above raise ``OSError`` naming what was found.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_SUPERBLOCK_SIZE = 48
_HEAP_MIN = 4096

# Object header message types.
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL_OLD, _FILL, _LINK, _LAYOUT = 0x04, 0x05, 0x06, 0x08
_GROUP_INFO, _FILTERS, _ATTRIBUTE = 0x0A, 0x0B, 0x0C
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x10, 0x11, 0x15

_UNSUPPORTED_MESSAGES = {
    0x07: "external data storage",
    _FILTERS: "a filter pipeline (compressed or filtered dataset)",
}

# The variable-length string type (h5py's ``string_dtype()``).
VLEN_STR = np.dtype("O", metadata={"vlen": str})

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_MASK = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _MASK


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, HDF5's metadata checksum."""
    length = len(data)
    a = b = c = (0xDEADBEEF + length + initval) & _MASK
    i = 0
    while length > 12:
        x, y, z = struct.unpack_from("<3I", data, i)
        a = (a + x) & _MASK
        b = (b + y) & _MASK
        c = (c + z) & _MASK
        a = (a - c) & _MASK; a ^= _rot(c, 4); c = (c + b) & _MASK
        b = (b - a) & _MASK; b ^= _rot(a, 6); a = (a + c) & _MASK
        c = (c - b) & _MASK; c ^= _rot(b, 8); b = (b + a) & _MASK
        a = (a - c) & _MASK; a ^= _rot(c, 16); c = (c + b) & _MASK
        b = (b - a) & _MASK; b ^= _rot(a, 19); a = (a + c) & _MASK
        c = (c - b) & _MASK; c ^= _rot(b, 4); b = (b + a) & _MASK
        length -= 12
        i += 12
    if length == 0:
        return c
    tail = data[i:] + bytes(12 - length)
    x, y, z = struct.unpack("<3I", tail)
    a = (a + x) & _MASK
    b = (b + y) & _MASK
    c = (c + z) & _MASK
    c ^= b; c = (c - _rot(b, 14)) & _MASK
    a ^= c; a = (a - _rot(c, 11)) & _MASK
    b ^= a; b = (b - _rot(a, 25)) & _MASK
    c ^= b; c = (c - _rot(b, 16)) & _MASK
    a ^= c; a = (a - _rot(c, 4)) & _MASK
    b ^= a; b = (b - _rot(a, 14)) & _MASK
    c ^= b; c = (c - _rot(b, 24)) & _MASK
    return c


def _checksummed(raw: bytes) -> bytes:
    return raw + _U32.pack(lookup3(raw))


# -- datatypes ----------------------------------------------------------------
def _is_vlen_str(dt: np.dtype) -> bool:
    return dt.kind == "O" and (dt.metadata or {}).get("vlen") is str


def _type_header(cls: int, version: int, bits: int, size: int) -> bytes:
    return (bytes([cls | (version << 4)]) + (bits & 0xFFFFFF).to_bytes(3, "little")
            + _U32.pack(size))


def _encode_int(size: int, signed: bool) -> bytes:
    return (_type_header(0, 1, 0x08 if signed else 0, size)
            + _U16.pack(0) + _U16.pack(8 * size))


def _encode_float(size: int) -> bytes:
    if size == 4:
        sign, exp_loc, exp_size, mant_size, bias = 31, 23, 8, 23, 127
    else:
        sign, exp_loc, exp_size, mant_size, bias = 63, 52, 11, 52, 1023
    # Bits 4-5 = 2: the mantissa's most significant bit is implied.
    return (_type_header(1, 1, 0x20 | (sign << 8), size)
            + _U16.pack(0) + _U16.pack(8 * size)
            + bytes([exp_loc, exp_size, 0, mant_size]) + _U32.pack(bias))


def _encode_dtype(dt: np.dtype) -> bytes:
    """The Datatype message body for a numpy dtype (little-endian)."""
    if _is_vlen_str(dt):
        # Variable-length string, null-terminated, UTF-8, over uint8.
        return _type_header(9, 1, 0x01 | (1 << 8), 16) + _encode_int(1, False)
    kind, size = dt.kind, dt.itemsize
    if kind == "b":
        # h5py's bool: an enum over int8 with members FALSE=0, TRUE=1.
        return (_type_header(8, 3, 2, 1) + _encode_int(1, True)
                + b"FALSE\x00TRUE\x00" + b"\x00\x01")
    if kind in "iu":
        return _encode_int(size, kind == "i")
    if kind == "f" and size in (4, 8):
        return _encode_float(size)
    if kind == "c" and size in (8, 16):
        # h5py's complex: a compound {r, i} of two floats (version 3: the
        # member offsets take the fewest bytes that hold the size).
        half = _encode_float(size // 2)
        return (_type_header(6, 3, 2, size) + b"r\x00" + bytes([0]) + half
                + b"i\x00" + bytes([size // 2]) + half)
    if kind == "V" and dt.names is None and dt.subdtype is None:
        return _type_header(5, 1, 0, size)  # opaque, empty tag
    raise TypeError(f"No HDF5 equivalent for dtype {dt!r} in h5lite.")


def _limit_enc_size(size: int) -> int:
    return (max(size, 1).bit_length() - 1) // 8 + 1


def _decode_dtype(b: bytes, p: int) -> Tuple[np.dtype, int]:
    """Decode a Datatype message at ``b[p:]``; returns ``(dtype, end)``."""
    cls, version = b[p] & 0x0F, b[p] >> 4
    bits = int.from_bytes(b[p + 1:p + 4], "little")
    size = _U32.unpack_from(b, p + 4)[0]
    q = p + 8
    if bits & 1 and cls in (0, 1):
        raise OSError("h5lite reads little-endian numbers only.")
    if cls == 0:
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}"), q + 4
    if cls == 1:
        return np.dtype(f"<f{size}"), q + 12
    if cls == 5:
        return np.dtype(f"V{size}"), q + (bits & 0xFF)
    if cls == 6:
        # Only h5py's complex: {r: float, i: float}. Member names are
        # null-terminated, padded to 8 bytes before version 3; version 1
        # members also carry an (unused) array description.
        names, parts = [], []
        for _ in range(bits & 0xFFFF):
            end = b.index(b"\x00", q)
            names.append(b[q:end].decode("utf-8"))
            if version < 3:
                q += (end - q) // 8 * 8 + 8 + 4 + (28 if version == 1 else 0)
            else:
                q = end + 1 + _limit_enc_size(size)
            member, q = _decode_dtype(b, q)
            parts.append(member)
        if names != ["r", "i"] or parts[0] != parts[1] or parts[0].kind != "f":
            raise OSError(f"h5lite reads compound types only as h5py's"
                          f" complex {{r, i}}, not {names}.")
        return np.dtype(f"<c{size}"), q
    if cls == 8:
        # Only h5py's bool: an int8 enum FALSE=0, TRUE=1 (names padded to
        # 8 bytes before version 3).
        base, q = _decode_dtype(b, q)
        names = []
        for _ in range(bits & 0xFFFF):
            end = b.index(b"\x00", q)
            names.append(b[q:end].decode("utf-8"))
            q = end + 1 if version >= 3 else q + (end - q) // 8 * 8 + 8
        values = b[q:q + len(names) * base.itemsize]
        if (base != np.dtype("i1") or names != ["FALSE", "TRUE"]
                or values != b"\x00\x01"):
            raise OSError(f"h5lite reads enum types only as h5py's bool, not"
                          f" {names}.")
        return np.dtype(bool), q + len(values)
    if cls == 9 and bits & 0x0F == 1:
        return VLEN_STR, _decode_dtype(b, q)[1]
    raise OSError(f"h5lite does not read HDF5 datatype class {cls}.")


def _storage_dtype(dt: np.dtype) -> np.dtype:
    """The dtype of the bytes on disk (little-endian; bool as int8)."""
    if dt.kind == "b":
        return np.dtype("i1")
    return dt.newbyteorder("<") if dt.byteorder == ">" else dt


# -- dataspaces -----------------------------------------------------------------
def _encode_dataspace(shape: Tuple[int, ...]) -> bytes:
    kind = 1 if shape else 0  # simple or scalar
    return bytes([2, len(shape), 0, kind]) + b"".join(
        _U64.pack(n) for n in shape)


def _decode_dataspace(b: bytes, p: int = 0) -> Tuple[int, ...]:
    """A simple or scalar dataspace of version 1 (8 reserved bytes before
    the sizes) or 2."""
    version, rank = b[p], b[p + 1]
    kind = b[p + 3] if version == 2 else (1 if rank else 0)
    if version not in (1, 2) or kind == 2:
        raise OSError(f"h5lite reads simple and scalar dataspaces of version"
                      f" 1 or 2, not version {version}, type {kind}.")
    q = p + (4 if version == 2 else 8)
    return tuple(_U64.unpack_from(b, q + 8 * i)[0] for i in range(rank))


# -- value conversion -------------------------------------------------------------
def _as_array(value) -> np.ndarray:
    """``value`` as a numpy array h5lite can store, or ``TypeError`` as
    h5py raises for objects with no HDF5 equivalent."""
    if isinstance(value, (str, np.str_)):
        return np.array(str(value), dtype=VLEN_STR)
    arr = np.asarray(value)
    if arr.dtype.kind == "O":
        if arr.size and all(isinstance(v, str) for v in arr.flat):
            return arr.astype(VLEN_STR)
        raise TypeError(
            f"Object dtype {arr.dtype!r} has no native HDF5 equivalent.")
    _encode_dtype(arr.dtype)  # raises TypeError if not storable
    return arr


def check_attribute(value) -> None:
    """Raise ``TypeError`` if ``value`` cannot be stored as an attribute
    (as h5py raises for objects with no HDF5 equivalent)."""
    _as_array(value)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    if len(body) > 0xFFFF:
        raise ValueError(
            f"HDF5 header message of {len(body)} bytes: h5lite stores"
            " attributes and links compactly, up to 65535 bytes each.")
    return bytes([mtype]) + _U16.pack(len(body)) + bytes([flags]) + body


def _encode_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    n = len(body)
    width = 0 if n < 1 << 8 else 1 if n < 1 << 16 else 2 if n < 1 << 32 else 3
    prefix = b"OHDR" + bytes([2, width]) + n.to_bytes(1 << width, "little")
    return _checksummed(prefix + body)


# -- object nodes ---------------------------------------------------------------
class _Node:
    """One object (group or dataset) of the file: its header's place and
    messages, loaded from disk or created since the file was opened."""

    def __init__(self, file: "File", addr: Optional[int] = None,
                 size: int = 0):
        self.file = file
        self.addr = addr          # header address on disk (None = new)
        self.size = size          # header bytes on disk
        self.dirty = addr is None
        self.attrs: Dict[str, bytes] = {}   # name -> Attribute message body

    def header_messages(self) -> List[bytes]:
        return [_message(_ATTRIBUTE, body) for body in self.attrs.values()]

    def blocks(self) -> List[Tuple[int, int]]:
        """The file blocks this object owns (its header)."""
        return [(self.addr, self.size)] if self.addr is not None else []


class _GroupNode(_Node):
    def __init__(self, file, addr=None, size=0, track_order=False):
        super().__init__(file, addr, size)
        self.track_order = track_order
        self.links: Dict[str, object] = {}   # name -> address or _Node
        self.order: Dict[str, int] = {}      # name -> creation order
        self.next_order = 0

    def child(self, name: str) -> _Node:
        target = self.links[name]
        if not isinstance(target, _Node):
            target = self.file._load(target)
            self.links[name] = target
        return target

    def names(self) -> List[str]:
        if self.track_order:
            return sorted(self.links, key=self.order.__getitem__)
        return sorted(self.links, key=lambda s: s.encode("utf-8"))

    def header_messages(self) -> List[bytes]:
        undef = _U64.pack(UNDEF)
        flags = 0x03 if self.track_order else 0x00
        linfo = bytes([0, flags])
        if self.track_order:
            linfo += _U64.pack(self.next_order)
        linfo += undef + undef + (undef if self.track_order else b"")
        messages = [_message(_LINK_INFO, linfo),
                    _message(_GROUP_INFO, bytes([0, 0]))]
        for name in self.names():
            target = self.links[name]
            addr = target.addr if isinstance(target, _Node) else target
            raw = name.encode("utf-8")
            width = 0 if len(raw) < 1 << 8 else 1
            flags = width | 0x10 | (0x04 if self.track_order else 0)
            body = bytes([1, flags])
            if self.track_order:
                body += _U64.pack(self.order[name])
            body += bytes([1]) + len(raw).to_bytes(1 << width, "little")
            messages.append(_message(_LINK, body + raw + _U64.pack(addr)))
        return messages + super().header_messages()


class _DatasetNode(_Node):
    def __init__(self, file, addr=None, size=0, *, shape=(), dtype=None,
                 data_addr=UNDEF, data_size=0):
        super().__init__(file, addr, size)
        self.shape = tuple(shape)
        self.dtype = dtype
        self.data_addr = data_addr
        self.data_size = data_size
        self.compact: Optional[bytes] = None   # data held in the header

    def header_messages(self) -> List[bytes]:
        # Fill value message version 3: allocation late, fill written
        # "if set", no fill value defined.
        layout = (bytes([3, 1]) + _U64.pack(self.data_addr)
                  + _U64.pack(self.data_size))
        return [
            _message(_DATASPACE, _encode_dataspace(self.shape)),
            _message(_DATATYPE, _encode_dtype(self.dtype), flags=0x01),
            _message(_FILL, bytes([3, 0x0A]), flags=0x01),
            _message(_LAYOUT, layout),
        ] + super().header_messages()

    def blocks(self):
        out = super().blocks()
        if self.data_addr != UNDEF and self.data_size:
            out.append((self.data_addr, self.data_size))
        return out


class _HeapCollection:
    """A global heap collection being filled since the file was opened."""

    def __init__(self, addr: int, size: int):
        self.addr = addr
        self.size = size
        self.objects: List[bytes] = []
        self.used = 16            # the collection header
        self.dirty = True

    def room(self) -> int:
        # Keep space for the free-space object's 16-byte header.
        return self.size - self.used - 16

    def add(self, data: bytes) -> int:
        self.objects.append(data)
        self.used += 16 + (len(data) + 7) // 8 * 8
        self.dirty = True
        return len(self.objects)

    def encode(self) -> bytes:
        out = [b"GCOL", bytes([1, 0, 0, 0]), _U64.pack(self.size)]
        for index, data in enumerate(self.objects, start=1):
            padded = data + bytes((-len(data)) % 8)
            out += [_U16.pack(index), _U16.pack(1), bytes(4),
                    _U64.pack(len(data)), padded]
        free = self.size - self.used
        out += [_U16.pack(0), _U16.pack(0), bytes(4), _U64.pack(free)]
        raw = b"".join(out)
        return raw + bytes(self.size - len(raw))


class _FractalHeap:
    """Reads the managed objects of a fractal heap (``FRHP``): the store of
    a group's links under dense link storage."""

    def __init__(self, file: "File", addr: int):
        raw = file._read(addr, 146)
        if raw[:4] != b"FRHP" or lookup3(raw[:142]) != _U32.unpack_from(
                raw, 142)[0]:
            raise OSError(f"No unfiltered fractal heap header at {addr}.")
        self.file = file
        self.id_len = _U16.unpack_from(raw, 5)[0]
        self.checksummed = bool(raw[9] & 0x02)
        max_managed = _U32.unpack_from(raw, 10)[0]
        self.width = _U16.unpack_from(raw, 110)[0]
        self.start, max_direct = struct.unpack_from("<2Q", raw, 112)
        max_bits = _U16.unpack_from(raw, 128)[0]
        self.root = _U64.unpack_from(raw, 132)[0]
        self.root_rows = _U16.unpack_from(raw, 140)[0]
        self.offset_size = (max_bits + 7) // 8
        self.length_size = _limit_enc_size(min(max_direct, max_managed))
        self.direct_rows = (max_direct.bit_length()
                            - self.start.bit_length() + 2)

    def object(self, heap_id: bytes) -> bytes:
        """The object a managed heap ID names."""
        if heap_id[0] & 0xF0:
            raise OSError("h5lite reads managed fractal heap objects only,"
                          " not huge or tiny ones.")
        o = 1 + self.offset_size
        offset = int.from_bytes(heap_id[1:o], "little")
        length = int.from_bytes(heap_id[o:o + self.length_size], "little")
        if self.root_rows:
            block, base = self._locate(self.root, self.root_rows, 0, offset)
        else:
            block, base = self.root, 0   # the root is a direct block
        return self.file._read(block + offset - base, length)

    def _locate(self, addr: int, rows: int, base: int, offset: int
                ) -> Tuple[int, int]:
        """The direct block holding heap ``offset`` below the indirect
        block at ``addr`` (``rows`` rows, covering the heap from
        ``base``): its address and its heap offset."""
        head = 13 + self.offset_size
        raw = self.file._read(addr, head + 8 * rows * self.width)
        if raw[:4] != b"FHIB":
            raise OSError(f"No fractal heap indirect block at {addr}.")
        for row in range(rows):
            size = self.start << max(row - 1, 0)
            if offset < base + self.width * size:
                col = (offset - base) // size
                child = _U64.unpack_from(raw, head + 8 * (row * self.width
                                                          + col))[0]
                base += col * size
                if row < self.direct_rows:
                    return child, base
                child_rows = (size.bit_length()
                              - (self.start * self.width).bit_length() + 1)
                return self._locate(child, child_rows, base, offset)
            base += self.width * size
        raise OSError(f"Fractal heap offset {offset} beyond the block at"
                      f" {addr}.")


# -- public objects -------------------------------------------------------------
class AttributeManager:
    """The ``attrs`` mapping of a group or dataset."""

    def __init__(self, node: _Node):
        self._node = node

    def __getitem__(self, name: str):
        if name not in self._node.attrs:
            raise KeyError(f"Can't open attribute (attribute {name!r} doesn't"
                           " exist)")
        return self._node.file._decode_attribute(self._node.attrs[name])

    def __setitem__(self, name: str, value) -> None:
        f = self._node.file
        f._check_writable()
        arr = _as_array(value)
        raw_name = name.encode("utf-8") + b"\x00"
        dtype_raw = _encode_dtype(arr.dtype)
        space_raw = _encode_dataspace(arr.shape)
        body = (bytes([3, 0]) + _U16.pack(len(raw_name))
                + _U16.pack(len(dtype_raw)) + _U16.pack(len(space_raw))
                + bytes([1]) + raw_name + dtype_raw + space_raw
                + f._encode_values(arr))
        _message(_ATTRIBUTE, body)  # raises if too large
        self._node.attrs.pop(name, None)
        self._node.attrs[name] = body
        self._node.dirty = True

    def __contains__(self, name) -> bool:
        return name in self._node.attrs

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._node.attrs)

    def keys(self):
        # h5py's order for attributes whose creation order is not tracked
        # (none is, in either writer's files): by name.
        return sorted(self._node.attrs, key=lambda s: s.encode("utf-8"))

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def get(self, name: str, default=None):
        return self[name] if name in self._node.attrs else default

    def update(self, other=(), **kwargs) -> None:
        for key, value in dict(other, **kwargs).items():
            self[key] = value


class Dataset:
    """A contiguous dataset; its data is read on each access."""

    def __init__(self, node: _DatasetNode, name: str):
        self._node = node
        self.name = name

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._node.shape

    @property
    def dtype(self) -> np.dtype:
        return self._node.dtype

    @property
    def attrs(self) -> AttributeManager:
        return AttributeManager(self._node)

    def __array__(self, dtype=None, copy=None):
        arr = self._node.file._read_dataset(self._node)
        return arr if dtype is None else arr.astype(dtype)

    def __getitem__(self, key):
        return self._node.file._read_dataset(self._node)[key]

    def __setitem__(self, key, value) -> None:
        """Overwrite the whole array in place (``ds[:] = value``, ``ds[...]
        = value`` or ``ds[()] = value``): ``value`` is cast to the
        dataset's dtype, must have its shape, and is written at the data's
        fixed address, so no header changes."""
        node = self._node
        f = node.file
        f._check_writable()
        whole = (key is Ellipsis or (isinstance(key, tuple) and not key)
                 or (isinstance(key, slice) and key == slice(None)))
        if not whole:
            raise TypeError("h5lite overwrites whole datasets only (ds[:] ="
                            " value).")
        if node.compact is not None or _is_vlen_str(node.dtype):
            raise TypeError(f"{self.name!r} is not a contiguous numeric"
                            " dataset.")
        arr = np.asarray(value, dtype=node.dtype)
        if arr.shape != node.shape:
            raise ValueError(f"Cannot write shape {arr.shape} into"
                             f" {self.name!r} of shape {node.shape}.")
        if node.data_size:
            data = np.ascontiguousarray(arr).astype(
                _storage_dtype(node.dtype), copy=False)
            f._write(node.data_addr, memoryview(data).cast("B"))


class Group:
    """A group: a mapping of names to groups and datasets."""

    def __init__(self, node: _GroupNode, name: str):
        self._node = node
        self.name = name

    @property
    def file(self) -> "File":
        return self._node.file

    @property
    def attrs(self) -> AttributeManager:
        return AttributeManager(self._node)

    def _path(self, name: str) -> str:
        return "/" + "/".join(p for p in (self.name + "/" + name).split("/")
                              if p)

    def _walk(self, path: str, create: bool = False
              ) -> Tuple[_GroupNode, str]:
        """The parent group node of ``path`` and the last name in it."""
        node = self.file._root if path.startswith("/") else self._node
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"Invalid path {path!r}.")
        for part in parts[:-1]:
            if part not in node.links:
                if not create:
                    raise KeyError(f"Unable to open object (component {part!r}"
                                   f" of {path!r} doesn't exist)")
                node = self.file._add_child(node, part, _GroupNode(self.file))
                continue
            node = node.child(part)
            if not isinstance(node, _GroupNode):
                raise KeyError(f"{part!r} in {path!r} is not a group.")
        return node, parts[-1]

    def _wrap(self, node: _Node, path: str):
        if isinstance(node, _GroupNode):
            return Group(node, path)
        return Dataset(node, path)

    def __getitem__(self, path: str):
        if path == "/":
            return Group(self.file._root, "/")
        parent, last = self._walk(path)
        if last not in parent.links:
            raise KeyError(f"Unable to open object (object {last!r} doesn't"
                           " exist)")
        return self._wrap(parent.child(last), self._path(path))

    def __contains__(self, path) -> bool:
        try:
            parent, last = self._walk(path)
        except (KeyError, ValueError):
            return False
        return last in parent.links

    def create_group(self, name: str, track_order: Optional[bool] = None
                     ) -> "Group":
        self.file._check_writable()
        parent, last = self._walk(name, create=True)
        if last in parent.links:
            raise ValueError(f"Unable to create group (name {name!r} already"
                             " exists)")
        node = _GroupNode(self.file, track_order=bool(track_order))
        self.file._add_child(parent, last, node)
        return Group(node, self._path(name))

    def require_group(self, name: str) -> "Group":
        if name in self:
            grp = self[name]
            if not isinstance(grp, Group):
                raise TypeError(f"Incompatible object ({name!r} is a"
                                " dataset) already exists")
            return grp
        return self.create_group(name)

    def __setitem__(self, name: str, value) -> None:
        f = self.file
        f._check_writable()
        arr = _as_array(value)
        parent, last = self._walk(name, create=True)
        if last in parent.links:
            raise ValueError(f"Unable to create dataset (name {name!r}"
                             " already exists)")
        f._add_child(parent, last, f._write_dataset(arr))

    def __delitem__(self, name: str) -> None:
        f = self.file
        f._check_writable()
        parent, last = self._walk(name)
        if last not in parent.links:
            raise KeyError(f"Unable to delete object ({name!r} doesn't"
                           " exist)")
        f._release(parent.child(last))
        del parent.links[last]
        parent.order.pop(last, None)
        parent.dirty = True

    def keys(self) -> List[str]:
        return self._node.names()

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._node.links)

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]


class File(Group):
    """An HDF5 file written and read by h5lite.

    Args:
        path: The file's path.
        mode: ``"r"`` read only; ``"r+"`` read and write an existing file;
            ``"w"`` create, truncating an existing file; ``"x"`` create,
            failing (``FileExistsError``) if the file exists.
    """

    def __init__(self, path, mode: str = "r"):
        path = os.fspath(path)
        if mode not in ("r", "r+", "w", "x"):
            raise ValueError(f"Invalid mode {mode!r}: use r, r+, w or x.")
        self.filename = path
        self.mode = mode
        self._fh = open(path, {"r": "rb", "r+": "r+b", "w": "w+b",
                               "x": "x+b"}[mode])
        self._free: List[List[int]] = []      # reusable [addr, size]
        self._pending: List[Tuple[int, int]] = []  # freed since last flush
        self._heaps: List[_HeapCollection] = []
        self._heap_cache: Dict[int, Dict[int, bytes]] = {}
        try:
            if mode in ("w", "x"):
                self._eof = _SUPERBLOCK_SIZE
                root = _GroupNode(self)
            else:
                root = self._read_superblock()
        except BaseException:
            self._fh.close()
            raise
        super().__init__(root, "/")
        self._root = root

    # -- context and lifetime -----------------------------------------------------
    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check_writable(self) -> None:
        if self._fh.closed:
            raise ValueError("The file is closed.")
        if self.mode == "r":
            raise ValueError("The file is open read-only.")

    def flush(self) -> None:
        """Write every changed header and heap, then the superblock."""
        if self.mode == "r" or self._fh.closed:
            return
        for heap in self._heaps:
            if heap.dirty:
                self._write(heap.addr, heap.encode())
                heap.dirty = False
        self._flush_node(self._root)
        self._fh.flush()
        if os.fstat(self._fh.fileno()).st_size < self._eof:
            self._fh.truncate(self._eof)
        superblock = (_SIGNATURE + bytes([2, 8, 8, 0]) + _U64.pack(0)
                      + _U64.pack(UNDEF) + _U64.pack(self._eof)
                      + _U64.pack(self._root.addr))
        self._write(0, _checksummed(superblock))
        self._fh.flush()
        # Nothing flushed refers to the freed blocks any more.
        for addr, size in self._pending:
            self._free.append([addr, size])
        self._pending = []

    def close(self) -> None:
        if self._fh.closed:
            return
        try:
            self.flush()
        finally:
            self._fh.close()

    # -- space ------------------------------------------------------------------------
    def _alloc(self, size: int) -> int:
        for block in self._free:
            if block[1] >= size:
                addr = block[0]
                block[0] += size
                block[1] -= size
                if not block[1]:
                    self._free.remove(block)
                return addr
        addr = self._eof
        self._eof += size
        return addr

    def _release(self, node: _Node) -> None:
        """Free the blocks of ``node`` and its subtree after the next
        flush."""
        if isinstance(node, _GroupNode):
            for name in list(node.links):
                self._release(node.child(name))
        self._pending.extend(node.blocks())

    def _write(self, addr: int, data) -> None:
        self._fh.seek(addr)
        self._fh.write(data)

    def _read(self, addr: int, size: int) -> bytes:
        if addr + size > self._eof:
            raise OSError(f"HDF5 read of {size} bytes at {addr} beyond the"
                          f" end of {self.filename!r}.")
        self._fh.seek(addr)
        data = self._fh.read(size)
        if len(data) != size:
            raise OSError(f"Truncated HDF5 file {self.filename!r}.")
        return data

    # -- writing ---------------------------------------------------------------------
    def _add_child(self, parent: _GroupNode, name: str, node: _Node) -> _Node:
        parent.links[name] = node
        parent.order[name] = parent.next_order
        parent.next_order += 1
        parent.dirty = True
        return node

    def _write_dataset(self, arr: np.ndarray) -> _DatasetNode:
        if _is_vlen_str(arr.dtype):
            data = self._encode_values(arr)
        else:
            store = _storage_dtype(arr.dtype)
            data = np.ascontiguousarray(arr).astype(store, copy=False)
            data = memoryview(data).cast("B") if data.size else b""
        size = len(data)
        addr = self._alloc(size) if size else UNDEF
        if size:
            self._write(addr, data)
        return _DatasetNode(self, shape=arr.shape, dtype=arr.dtype,
                            data_addr=addr, data_size=size)

    def _heap_insert(self, data: bytes) -> Tuple[int, int]:
        need = 16 + (len(data) + 7) // 8 * 8
        heap = next((h for h in self._heaps if h.room() >= need), None)
        if heap is None:
            size = max(_HEAP_MIN, need + 48)
            heap = _HeapCollection(self._alloc(size), size)
            self._heaps.append(heap)
        index = heap.add(data)
        self._heap_cache.setdefault(heap.addr, {})[index] = data
        return heap.addr, index

    def _encode_values(self, arr: np.ndarray) -> bytes:
        if not _is_vlen_str(arr.dtype):
            return np.ascontiguousarray(arr).astype(
                _storage_dtype(arr.dtype), copy=False).tobytes()
        out = []
        for value in arr.flat:
            raw = str(value).encode("utf-8")
            addr, index = self._heap_insert(raw)
            out.append(_U32.pack(len(raw)) + _U64.pack(addr) + _U32.pack(index))
        return b"".join(out)

    def _flush_node(self, node: _Node) -> None:
        if isinstance(node, _GroupNode):
            for name, target in node.links.items():
                if isinstance(target, _Node):
                    old = target.addr
                    self._flush_node(target)
                    if target.addr != old:
                        node.dirty = True
        if not node.dirty:
            return
        raw = _encode_header(node.header_messages())
        if node.addr is not None:
            self._pending.append((node.addr, node.size))
        node.addr = self._alloc(len(raw))
        node.size = len(raw)
        self._write(node.addr, raw)
        node.dirty = False

    # -- reading ---------------------------------------------------------------------
    def _read_superblock(self) -> _GroupNode:
        self._eof = os.fstat(self._fh.fileno()).st_size
        head = self._read(0, min(self._eof, 96))
        if head[:8] != _SIGNATURE:
            raise OSError(f"{self.filename!r} is not an HDF5 file (no"
                          " signature at offset 0).")
        version = head[8]
        if version in (0, 1):
            # HDF5's default format: written by h5py, read only here.
            if self.mode != "r":
                raise OSError(
                    f"{self.filename!r} is in HDF5's default format"
                    f" (superblock version {version}); h5lite opens such"
                    " files read only, and appends only to files it wrote.")
            if head[13] != 8 or head[14] != 8:
                raise OSError("h5lite reads 8-byte offsets and lengths only.")
            p = 24 if version == 0 else 28
            base, _, eoa, _ = struct.unpack_from("<4Q", head, p)
            if base != 0:
                raise OSError(f"{self.filename!r} has a base address of"
                              f" {base}; h5lite reads base address 0 only.")
            root_addr = _U64.unpack_from(head, p + 40)[0]
        elif version in (2, 3):
            if head[9] != 8 or head[10] != 8:
                raise OSError("h5lite reads 8-byte offsets and lengths only.")
            if lookup3(head[:44]) != _U32.unpack_from(head, 44)[0]:
                raise OSError(f"Bad superblock checksum in {self.filename!r}.")
            eoa = _U64.unpack_from(head, 28)[0]
            root_addr = _U64.unpack_from(head, 36)[0]
        else:
            raise OSError(f"{self.filename!r} has HDF5 superblock version"
                          f" {version}; h5lite reads versions 0 to 3.")
        if eoa > self._eof:
            raise OSError(f"Truncated HDF5 file {self.filename!r}: end of"
                          f" allocation {eoa} beyond its {self._eof} bytes.")
        self._eof = eoa
        root = self._load(root_addr)
        if not isinstance(root, _GroupNode):
            raise OSError("The HDF5 root object is not a group.")
        return root

    def _read_header(self, addr: int) -> Tuple[List[Tuple[int, bytes]], int]:
        """The messages of the object header at ``addr`` (version 1 or 2,
        continuation blocks followed) and the size of its first chunk."""
        head = self._read(addr, 16)
        if head[:4] == b"OHDR":
            flags = head[5]
            pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 0x03)
            prefix = self._read(addr, pos + width)
            chunk = int.from_bytes(prefix[pos:pos + width], "little")
            total = pos + width + chunk + 4
            blocks = [(addr, total, pos + width)]
            step = 6 if flags & 0x04 else 4
        elif head[0] == 1:
            total = 16 + _U32.unpack_from(head, 8)[0]
            blocks = [(addr, total, 16)]
            step = 8
        else:
            raise OSError(f"No HDF5 object header at address {addr}.")
        messages = []
        while blocks:
            start, size, p = blocks.pop(0)
            raw = self._read(start, size)
            end = size
            if step != 8:  # version 2: every chunk ends with a checksum
                if lookup3(raw[:-4]) != _U32.unpack_from(raw, size - 4)[0]:
                    raise OSError(f"Bad object header checksum at {start}.")
                end -= 4
            while p + step <= end:
                if step == 8:
                    mtype, msize, mflags = struct.unpack_from("<HHB", raw, p)
                else:
                    mtype, msize = raw[p], _U16.unpack_from(raw, p + 1)[0]
                    mflags = raw[p + 3]
                body = raw[p + step:p + step + msize]
                p += step + msize
                if mtype == _CONTINUATION:
                    where, length = struct.unpack_from("<2Q", body)
                    if step == 8:
                        blocks.append((where, length, 0))
                    elif self._read(where, 4) != b"OCHK":
                        raise OSError(f"No object header continuation at"
                                      f" {where}.")
                    else:
                        blocks.append((where, length, 4))
                    continue
                if mtype in _UNSUPPORTED_MESSAGES:
                    raise OSError(f"The object at {addr} uses"
                                  f" {_UNSUPPORTED_MESSAGES[mtype]}; h5lite"
                                  " does not read it.")
                if mflags & 0x02:
                    raise OSError(f"The object at {addr} uses a shared"
                                  " (committed) message; h5lite does not read"
                                  " it.")
                messages.append((mtype, body))
        return messages, total

    def _load(self, addr: int) -> _Node:
        try:
            return self._load_node(addr)
        except (struct.error, IndexError, ValueError,
                UnicodeDecodeError) as exc:
            # A torn read (a writer mid-flush) or a damaged file.
            raise OSError(f"Malformed HDF5 object at {addr} in"
                          f" {self.filename!r}: {exc}") from exc

    def _load_node(self, addr: int) -> _Node:
        messages, size = self._read_header(addr)
        types = {m[0] for m in messages}
        if _LINK_INFO in types or _SYMBOL_TABLE in types:
            node = _GroupNode(self, addr, size)
            for mtype, body in messages:
                if mtype == _LINK_INFO:
                    flags = body[1]
                    q = 2
                    if flags & 0x01:
                        node.next_order = _U64.unpack_from(body, q)[0]
                        q += 8
                    node.track_order = bool(flags & 0x01)
                    heap, names = struct.unpack_from("<2Q", body, q)
                    if heap != UNDEF:
                        for link in self._dense_links(heap, names):
                            self._add_link(node, link, addr)
                elif mtype == _LINK:
                    self._add_link(node, body, addr)
                elif mtype == _SYMBOL_TABLE:
                    node.links.update(self._symbol_table(body))
                elif mtype == _ATTRIBUTE:
                    node.attrs[self._attribute_name(body)] = body
                elif mtype == _ATTRIBUTE_INFO:
                    self._check_attribute_info(body, addr)
            if node.track_order and len(node.order) != len(node.links):
                raise OSError(f"The group at {addr} tracks creation order but"
                              " a link lacks it.")
            return node
        if _LAYOUT in types:
            node = _DatasetNode(self, addr, size)
            for mtype, body in messages:
                if mtype == _DATASPACE:
                    node.shape = _decode_dataspace(body)
                elif mtype == _DATATYPE:
                    node.dtype = _decode_dtype(body, 0)[0]
                elif mtype == _LAYOUT:
                    self._decode_layout(node, body, addr)
                elif mtype == _ATTRIBUTE:
                    node.attrs[self._attribute_name(body)] = body
                elif mtype == _ATTRIBUTE_INFO:
                    self._check_attribute_info(body, addr)
            return node
        raise OSError(f"The object at {addr} is neither a group nor a"
                      " dataset.")

    def _add_link(self, node: _GroupNode, body: bytes, addr: int) -> None:
        name, order, target = self._decode_link(body, addr)
        node.links[name] = target
        if order is not None:
            node.order[name] = order

    @staticmethod
    def _decode_link(body: bytes, addr: int):
        flags = body[1]
        q = 2
        link_type = 0
        if flags & 0x08:
            link_type = body[q]
            q += 1
        order = None
        if flags & 0x04:
            order = _U64.unpack_from(body, q)[0]
            q += 8
        if flags & 0x10:
            q += 1
        width = 1 << (flags & 0x03)
        n = int.from_bytes(body[q:q + width], "little")
        q += width
        name = body[q:q + n].decode("utf-8")
        q += n
        if link_type != 0:
            raise OSError(f"The group at {addr} holds a soft or external link"
                          f" {name!r}; h5lite reads hard links only.")
        return name, order, _U64.unpack_from(body, q)[0]

    # -- HDF5's default format: symbol tables, fractal heaps, B-trees ----------
    def _symbol_table(self, body: bytes) -> Dict[str, int]:
        """``{name: header address}`` of a symbol-table group: the leaves
        (``SNOD`` nodes) of its version-1 group B-tree, in key order,
        with names from its local heap."""
        btree, heap = struct.unpack_from("<2Q", body)
        head = self._read(heap, 32)
        if head[:4] != b"HEAP":
            raise OSError(f"No local heap at {heap}.")
        size, _, data_addr = struct.unpack_from("<3Q", head, 8)
        names = self._read(data_addr, size)
        links: Dict[str, int] = {}
        pending = [btree]
        while pending:
            node = pending.pop(0)
            head = self._read(node, 24)
            if head[:4] != b"TREE" or head[4] != 0:
                raise OSError(f"No group B-tree node at {node}.")
            level, used = head[5], _U16.unpack_from(head, 6)[0]
            raw = self._read(node, 24 + 16 * used + 8)
            children = [_U64.unpack_from(raw, 32 + 16 * i)[0]
                        for i in range(used)]
            if level:
                pending[:0] = children
                continue
            for snod in children:
                head = self._read(snod, 8)
                if head[:4] != b"SNOD":
                    raise OSError(f"No symbol-table node at {snod}.")
                count = _U16.unpack_from(head, 6)[0]
                raw = self._read(snod + 8, 40 * count)
                for i in range(count):
                    offset, target = struct.unpack_from("<2Q", raw, 40 * i)
                    end = names.index(b"\x00", offset)
                    links[names[offset:end].decode("utf-8")] = target
        return links

    def _dense_links(self, heap_addr: int, btree_addr: int) -> List[bytes]:
        """The Link message bodies of a group with dense link storage: the
        objects of its fractal heap whose IDs its name index holds."""
        heap = _FractalHeap(self, heap_addr)
        return [heap.object(record[-heap.id_len:])
                for record in self._btree2_records(btree_addr)]

    def _btree2_records(self, addr: int) -> List[bytes]:
        """Every record of the version-2 B-tree at ``addr``."""
        head = self._read(addr, 38)
        if head[:4] != b"BTHD" or lookup3(head[:34]) != _U32.unpack_from(
                head, 34)[0]:
            raise OSError(f"No version-2 B-tree header at {addr}.")
        node_size, rec_size, depth = struct.unpack_from("<IHH", head, 6)
        root, root_count = struct.unpack_from("<QH", head, 16)
        # Field widths of the internal nodes' child pointers, as the
        # library derives them from the node size (H5B2__hdr_init).
        max_leaf = (node_size - 10) // rec_size
        count_size = _limit_enc_size(max_leaf)
        cum_max, cum_size = [max_leaf], [0]
        for d in range(1, depth + 1):
            ptr = 8 + count_size + (cum_size[d - 1] if d > 1 else 0)
            most = (node_size - 10 - ptr) // (rec_size + ptr)
            cum_max.append((most + 1) * cum_max[d - 1] + most)
            cum_size.append(_limit_enc_size(cum_max[d]))
        records: List[bytes] = []

        def walk(node: int, count: int, d: int) -> None:
            ptr = 8 + count_size + (cum_size[d - 1] if d > 1 else 0)
            size = 10 + count * rec_size + (ptr * (count + 1) if d else 0)
            raw = self._read(node, size)
            if raw[:4] != (b"BTIN" if d else b"BTLF"):
                raise OSError(f"No version-2 B-tree node at {node}.")
            records.extend(raw[6 + i * rec_size:6 + (i + 1) * rec_size]
                           for i in range(count))
            q = 6 + count * rec_size
            for _ in range(count + 1 if d else 0):
                child = _U64.unpack_from(raw, q)[0]
                walk(child, int.from_bytes(raw[q + 8:q + 8 + count_size],
                                           "little"), d - 1)
                q += ptr

        if root != UNDEF:
            walk(root, root_count, depth)
        return records

    @staticmethod
    def _decode_layout(node: _DatasetNode, body: bytes, addr: int) -> None:
        """Contiguous or compact layouts of versions 1 to 4."""
        version = body[0]
        cls = body[2] if version < 3 else body[1]
        if version not in (1, 2, 3, 4) or cls not in (0, 1):
            what = {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
            raise OSError(f"The dataset at {addr} has a {what} layout"
                          f" (version {version}); h5lite reads contiguous"
                          " and compact layouts only.")
        if version >= 3:
            if cls == 1:
                node.data_addr, node.data_size = struct.unpack_from(
                    "<2Q", body, 2)
            else:
                n = _U16.unpack_from(body, 2)[0]
                node.compact = body[4:4 + n]
            return
        # Versions 1 and 2: the sizes (4 bytes each; the last one is the
        # element size) follow the address, which compact data lacks.
        rank = body[1]
        q = 8 + (8 if cls == 1 else 0)
        dims = struct.unpack_from(f"<{rank}I", body, q)
        if cls == 1:
            node.data_addr = _U64.unpack_from(body, 8)[0]
            node.data_size = int(np.prod(dims, dtype=np.int64))
        else:
            q += 4 * rank
            n = _U32.unpack_from(body, q)[0]
            node.compact = body[q + 4:q + 4 + n]

    @staticmethod
    def _check_attribute_info(body: bytes, addr: int) -> None:
        q = 2 + (2 if body[1] & 0x01 else 0)
        if _U64.unpack_from(body, q)[0] != UNDEF:
            raise OSError(f"The object at {addr} uses dense attribute storage"
                          " (a fractal heap); h5lite does not read it.")

    @staticmethod
    def _attribute_layout(body: bytes) -> Tuple[int, int, int, int]:
        """Offsets of an Attribute message's name, datatype, dataspace and
        data. Version 1 pads each of the first three to 8 bytes; versions 2
        and 3 do not (version 3 adds a character-set byte)."""
        version = body[0]
        if version not in (1, 2, 3) or (version > 1 and body[1] & 0x03):
            raise OSError(f"h5lite reads unshared attribute messages of"
                          f" versions 1 to 3, not version {version}.")
        sizes = struct.unpack_from("<3H", body, 2)
        if version == 1:
            sizes = [(n + 7) // 8 * 8 for n in sizes]
        name = 8 if version == 1 else 8 + (version == 3)
        dtype = name + sizes[0]
        space = dtype + sizes[1]
        return name, dtype, space, space + sizes[2]

    def _attribute_name(self, body: bytes) -> str:
        name = self._attribute_layout(body)[0]
        return body[name:body.index(b"\x00", name)].decode("utf-8")

    def _decode_attribute(self, body: bytes):
        _, dtype_at, space_at, data_at = self._attribute_layout(body)
        dtype = _decode_dtype(body, dtype_at)[0]
        shape = _decode_dataspace(body, space_at)
        return self._decode_values(body[data_at:], dtype, shape)

    def _decode_values(self, data: bytes, dtype: np.dtype,
                       shape: Tuple[int, ...]):
        count = int(np.prod(shape, dtype=np.int64))
        if dtype.kind == "O":
            values = []
            for i in range(count):
                n, addr, index = struct.unpack_from("<IQI", data, 16 * i)
                raw = self._heap_object(addr, index)[:n] if n else b""
                values.append(raw.decode("utf-8"))
            if not shape:
                return values[0]
            return np.array(values, dtype=dtype).reshape(shape)
        arr = np.frombuffer(data, _storage_dtype(dtype), count).reshape(shape)
        arr = arr.astype(dtype) if dtype.kind == "b" else arr.copy()
        return arr[()] if not shape else arr

    def _read_dataset(self, node: _DatasetNode) -> np.ndarray:
        if self._fh.closed:
            raise ValueError("The file is closed.")
        if node.compact is not None:
            data = node.compact
        elif node.data_addr == UNDEF:
            # Never written (zero-size): the fill value.
            return np.zeros(node.shape, dtype=node.dtype)
        else:
            data = self._read(node.data_addr, node.data_size)
        out = self._decode_values(data, node.dtype, node.shape)
        return np.asarray(out, dtype=node.dtype) if not node.shape else out

    def _heap_object(self, addr: int, index: int) -> bytes:
        if addr not in self._heap_cache or index not in self._heap_cache[addr]:
            head = self._read(addr, 16)
            if head[:4] != b"GCOL":
                raise OSError(f"No global heap collection at {addr}.")
            size = _U64.unpack_from(head, 8)[0]
            raw = self._read(addr, size)
            objects, p = {}, 16
            while p + 16 <= size:
                idx = _U16.unpack_from(raw, p)[0]
                n = _U64.unpack_from(raw, p + 8)[0]
                if idx == 0:
                    break
                objects[idx] = raw[p + 16:p + 16 + n]
                p += 16 + (n + 7) // 8 * 8
            self._heap_cache.setdefault(addr, {}).update(objects)
        try:
            return self._heap_cache[addr][index]
        except KeyError:
            raise OSError(f"No object {index} in the global heap at"
                          f" {addr}.") from None
