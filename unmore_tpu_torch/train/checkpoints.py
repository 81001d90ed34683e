"""Reader of the JAX trainers' msgpack checkpoints, without msgpack or flax.

The JAX trainers save their state with flax's ``msgpack_serialize``: a
msgpack map of maps whose array leaves are ext objects. This module parses
that format itself, so that weights trained there load into the port on a
machine that has neither ``msgpack`` nor ``flax`` (nor ``ml_dtypes`` for
bfloat16):

* maps, arrays, str, bin, ints, floats, nil and bool; ext objects in the
  ``fixext`` and ``ext8/16/32`` forms;
* ext code 1, an ndarray: its payload is itself msgpack, ``(shape,
  dtype_name, bytes)`` in C order;
* ext code 3, a numpy scalar, the same payload with shape ``()``;
* ``bfloat16`` leaves, decoded as ``uint16 << 16`` viewed as float32
  (exact: a bfloat16 is the top half of a float32);
* leaves over 1 GiB that flax splits into chunks
  (``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": ...}}``), joined again.

:func:`load_msgpack_checkpoint` returns the tree with numpy leaves, equal
to flax's ``msgpack_restore`` but for bfloat16 leaves, which come back as
float32 holding the same values.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
# type byte -> big-endian struct format of the value (or of the length) that follows
_UINTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_INTS = {0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FLOATS = {0xCA: ">f", 0xCB: ">d"}
_STR_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_EXT_LEN = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT_LEN = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_ARRAY_LEN = {0xDC: ">H", 0xDD: ">I"}
_MAP_LEN = {0xDE: ">H", 0xDF: ">I"}


class MsgpackError(ValueError):
    """The bytes are not a msgpack checkpoint this reader understands."""


class _Reader:
    """One msgpack object from ``buf``; with ``views``, bin values come back
    as memoryviews of ``buf`` rather than copies (for array payloads)."""

    def __init__(self, buf, views: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.views = views

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int) -> str:
        try:
            return str(self._take(n), "utf-8")
        except UnicodeDecodeError as exc:
            raise MsgpackError(f"invalid utf-8 string: {exc}") from None

    def read(self):
        head = self._take(1)[0]
        if head <= 0x7F:
            return head
        if head >= 0xE0:
            return head - 0x100
        if 0x80 <= head <= 0x8F:
            return self._map(head & 0x0F)
        if 0x90 <= head <= 0x9F:
            return self._array(head & 0x0F)
        if 0xA0 <= head <= 0xBF:
            return self._str(head & 0x1F)
        if head == 0xC0:
            return None
        if head in (0xC2, 0xC3):
            return head == 0xC3
        if head in _UINTS:
            return self._unpack(_UINTS[head])
        if head in _INTS:
            return self._unpack(_INTS[head])
        if head in _FLOATS:
            return self._unpack(_FLOATS[head])
        if head in _STR_LEN:
            return self._str(self._unpack(_STR_LEN[head]))
        if head in _BIN_LEN:
            data = self._take(self._unpack(_BIN_LEN[head]))
            return data if self.views else bytes(data)
        if head in _ARRAY_LEN:
            return self._array(self._unpack(_ARRAY_LEN[head]))
        if head in _MAP_LEN:
            return self._map(self._unpack(_MAP_LEN[head]))
        if head in _FIXEXT_LEN:
            code = self._unpack(">b")
            return _ext(code, self._take(_FIXEXT_LEN[head]))
        if head in _EXT_LEN:
            n = self._unpack(_EXT_LEN[head])
            code = self._unpack(">b")
            return _ext(code, self._take(n))
        raise MsgpackError(f"unknown msgpack type byte 0x{head:02x}")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            try:
                out[key] = self.read()
            except TypeError:  # an unhashable key: not a checkpoint
                raise MsgpackError(f"map key of type {type(key).__name__}") from None
        return out


def _parse(buf, views: bool = False):
    reader = _Reader(buf, views)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise MsgpackError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return obj


def _ndarray(payload) -> np.ndarray:
    """flax's ndarray payload: msgpack of (shape, dtype name, C-order bytes)."""
    try:
        shape, dtype_name, data = _parse(payload, views=True)
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode("ascii")
        shape = tuple(int(d) for d in shape)
        if dtype_name == "bfloat16":
            bits = np.frombuffer(data, dtype=np.uint16).astype(np.uint32) << 16
            return bits.view(np.float32).reshape(shape)
        return np.frombuffer(data, dtype=np.dtype(dtype_name)).reshape(shape)
    except (TypeError, ValueError) as exc:  # a malformed payload; MsgpackError is a ValueError
        raise MsgpackError(f"bad ndarray payload: {exc}") from None


def _ext(code: int, payload):
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise MsgpackError(f"unsupported msgpack ext code {code}")


def _as_tuple(d: dict) -> tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree):
    """Join flax's chunked leaves again, wherever maps nest them."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        return np.concatenate(_as_tuple(tree["chunks"])).reshape(_as_tuple(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def parse_msgpack_checkpoint(data: bytes) -> dict:
    """The tree of a flax msgpack checkpoint held in ``data`` (see the
    module note). Raises :class:`MsgpackError` if it is not one."""
    tree = _unchunk(_parse(data))
    if not isinstance(tree, dict):
        raise MsgpackError(f"a checkpoint is a map, this holds a {type(tree).__name__}")
    return tree


def load_msgpack_checkpoint(path: str) -> dict:
    """The tree of the flax msgpack checkpoint at ``path``, numpy leaves."""
    with open(path, "rb") as f:
        return parse_msgpack_checkpoint(f.read())


def try_msgpack_checkpoint(path: str) -> dict | None:
    """:func:`load_msgpack_checkpoint`, or None when the file is not one
    (a torch checkpoint, say)."""
    try:
        return load_msgpack_checkpoint(path)
    except MsgpackError:
        return None
