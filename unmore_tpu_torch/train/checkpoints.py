"""The JAX trainers' msgpack checkpoints, read and written without msgpack or flax.

The JAX trainers save their state with flax's ``msgpack_serialize``: a
msgpack map of maps whose array leaves are ext objects. This module parses
and writes that format itself, so that weights trained in either package
load into the other, on a machine that has neither ``msgpack`` nor ``flax``
(nor ``ml_dtypes`` for bfloat16). The reader takes:

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

The writer (:func:`save_checkpoint`, :class:`AsyncCheckpointer`) emits the
bytes ``msgpack_serialize`` emits for a tree of dicts with string keys (keys
sorted, as flax writes a tree's maps): ndarray
leaves (0-d ones included) as ext 1, numpy scalars as ext 3, leaves over
:data:`MAX_CHUNK_SIZE` bytes as flax's chunked maps, Python ints, floats,
strings, bools and None as plain msgpack. Files are written to
``<path>.tmp`` and renamed, so a crash never leaves a truncated file under
the final name.
"""

from __future__ import annotations

import os
import struct
import threading
import time

import numpy as np
import torch

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


# ------------------------------------------------------------------ writer
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE: larger leaves are chunked


def _pack_len(out, n: int, fix: int | None, fix_max: int, heads: tuple[int, int, int]):
    """A header: ``fix | n`` when it fits, else a 1-, 2- or 4-byte length."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack(">B", fix | n))
    elif n < 2**8 and heads[0]:
        out.append(struct.pack(">BB", heads[0], n))
    elif n < 2**16:
        out.append(struct.pack(">BH", heads[1], n))
    else:
        out.append(struct.pack(">BI", heads[2], n))


def _pack_int(out, v: int):
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for head, fmt, top in ((0xCC, ">BB", 2**8), (0xCD, ">BH", 2**16), (0xCE, ">BI", 2**32), (0xCF, ">BQ", 2**64)):
            if v < top:
                out.append(struct.pack(fmt, head, v))
                return
        raise OverflowError(v)
    else:
        for head, fmt, low in ((0xD0, ">Bb", -(2**7)), (0xD1, ">Bh", -(2**15)), (0xD2, ">Bi", -(2**31)),
                               (0xD3, ">Bq", -(2**63))):
            if v >= low:
                out.append(struct.pack(fmt, head, v))
                return
        raise OverflowError(v)


def _pack_str(out, s: str):
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out.append(b)


def _pack_bin(out, b):
    _pack_len(out, len(b), None, -1, (0xC4, 0xC5, 0xC6))
    out.append(b)


def _ndarray_payload(a: np.ndarray) -> list:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, C bytes);
    the data as a memoryview, not a copy."""
    if not a.flags.c_contiguous:
        a = a.copy(order="C")  # (np.ascontiguousarray would turn a 0-d array 1-d)
    if a.dtype.hasobject:
        raise TypeError("object arrays are not serializable")
    out = [struct.pack(">B", 0x93)]
    _pack_len(out, a.ndim, 0x90, 15, (0, 0xDC, 0xDD))
    for d in a.shape:
        _pack_int(out, int(d))
    _pack_str(out, a.dtype.name)
    _pack_bin(out, memoryview(a.reshape(-1)).cast("B"))
    return out


def _pack_ext(out, code: int, payload: list):
    n = sum(len(p) for p in payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    elif n < 2**8:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < 2**16:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.extend(payload)


def _chunked(a: np.ndarray) -> dict:
    """flax's ``_chunk``: a leaf over MAX_CHUNK_SIZE bytes as flat chunks."""
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[s : s + size] for i, s in enumerate(range(0, flat.size, size))}}


def _pack(out, obj, sort_keys: bool = True):
    if isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        if not all(isinstance(k, str) for k in obj):
            raise TypeError(f"checkpoint keys are strings, got {sorted(map(type, obj), key=str)}")
        # flax writes a tree's maps with sorted keys, and the maps of a
        # chunked leaf in the order it builds them
        sort_keys = sort_keys and _CHUNKED not in obj
        for k in sorted(obj) if sort_keys else obj:
            v = obj[k]
            _pack_str(out, k)
            if isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
                v = _chunked(v)
            _pack(out, v, sort_keys)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    elif obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        _pack_str(out, obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_bin(out, obj)
    else:
        raise TypeError(f"unserializable checkpoint leaf {type(obj).__name__}")


def serialize(tree) -> list:
    """The msgpack bytes of ``tree`` as a list of byte chunks (array data
    as memoryviews of the arrays)."""
    out: list = []
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        tree = _chunked(tree)
    _pack(out, tree)
    return out


def save_checkpoint(path: str, tree) -> int:
    """Write ``tree`` (numpy leaves) to ``path`` atomically; returns the bytes written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    n = 0
    with open(tmp, "wb") as f:
        for chunk in serialize(tree):
            n += f.write(chunk)
    os.replace(tmp, path)
    return n


class AsyncCheckpointer:
    """Checkpoint writes that do not hold up training.

    :meth:`save` copies the state's tensors on the card, in stream order
    behind the steps already queued, and returns; a host thread then waits
    for those copies, pulls them to the host on a side stream, builds the
    tree and writes it (atomically, as :func:`save_checkpoint`). One save is
    in flight at a time: a new :meth:`save` first drains the previous one.
    :meth:`wait` drains before exit. A fatal exit while a write is in flight
    leaves only ``<path>.tmp``: the newest durable checkpoint stays the
    previous one.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last: dict = {}  # path, bytes and seconds of the newest finished write

    def save(self, path: str, tensors: dict, build) -> None:
        """Snapshot ``tensors`` (name -> tensor) now; later write
        ``build(host copies by name)`` to ``path``."""
        self.wait()
        t0 = time.perf_counter()
        with torch.no_grad():
            snap = {k: v.detach().clone() for k, v in tensors.items()}
        cuda = next((v.device for v in snap.values() if v.is_cuda), None)
        ready = None
        if cuda is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(cuda))
        # the thread takes the snapshot out of this list, so that the card's
        # copies are freed once they reach the host, not when the file is written
        self._thread = threading.Thread(target=self._write, args=(path, [snap], cuda, ready, build, t0), daemon=True)
        self._thread.start()

    def _write(self, path, box, cuda, ready, build, t0):
        try:
            snap = box.pop()
            if cuda is not None:
                ready.synchronize()
                with torch.cuda.device(cuda), torch.cuda.stream(torch.cuda.Stream(cuda)):
                    host = {k: v.cpu().numpy() for k, v in snap.items()}
            else:
                host = {k: v.numpy() for k, v in snap.items()}
            del snap
            n = save_checkpoint(path, build(host))
            self.last = {"path": path, "bytes": n, "seconds": time.perf_counter() - t0}
        except BaseException as exc:  # raised again by wait() in the training thread
            self._error = exc

    def wait(self) -> dict:
        """Block until the write in flight is durable; raise its error, if
        any. Returns :attr:`last`."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc
        return self.last
