"""Checkpoints — the port of srsem/train/checkpoint.py: the JAX package's
``step_N.msgpack`` files and ``latest.json`` pointer, read and written
without flax or msgpack (neither is installed where the port runs).

A checkpoint holds the trainable subset, never the frozen tower:
``{"trainable": ..., "opt_state": ..., "batch_stats": ...}`` (srsem/train/
loop.py:138-142).  The scoring CLIs merge ``restored["trainable"]`` into
the model (srsem_torch/cli/main.py).

The file format is flax's (flax/serialization.py, ``to_bytes`` /
``msgpack_restore``), a subset of msgpack:

* maps with string keys (flax turns lists, tuples and named tuples into
  maps keyed ``"0"``, ``"1"``, ... or by field), str and bin, ints,
  float64, nil and bool;
* ext type 1, an ndarray: ``packb((shape, dtype_name, C-order bytes))``;
* ext type 3, a numpy scalar, the same payload with shape ``()``;
* an array over ``MAX_CHUNK_SIZE`` bytes as a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat_chunk0, ...}}``.

Read back, a ``bfloat16`` leaf is a ``torch.bfloat16`` tensor (numpy has
no bfloat16); every other array is a numpy array, every scalar a numpy
scalar.  ``msgpack_serialize`` writes the bytes flax writes for the same
tree.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

#: flax.serialization.MAX_CHUNK_SIZE: arrays over this many bytes are
#: written as chunked maps.
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---- encoding ------------------------------------------------------------


def _header(out: List[bytes], n: int, fix: int, fix_max: int,
            codes: Tuple[Tuple[int, str], ...]) -> None:
    """A length header: the fix form below ``fix_max``, else the smallest
    of ``codes`` ((code, struct format of the length), ...)."""
    if fix_max and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"msgpack object of {n} is too large")


_STR = ((0xD9, "B"), (0xDA, "H"), (0xDB, "I"))
_BIN = ((0xC4, "B"), (0xC5, "H"), (0xC6, "I"))
_ARRAY = ((0xDC, "H"), (0xDD, "I"))
_MAP = ((0xDE, "H"), (0xDF, "I"))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, "B"), (0xC8, "H"), (0xC9, "I"))


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif v > 0:
        for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                               (0xCE, "I", 0xFFFFFFFF),
                               (0xCF, "Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                out.append(struct.pack(">B" + fmt, code, v))
                return
        raise OverflowError(f"integer {v} out of msgpack's range")
    else:
        for code, fmt, low in ((0xD0, "b", -0x80), (0xD1, "h", -0x8000),
                               (0xD2, "i", -0x80000000),
                               (0xD3, "q", -0x8000000000000000)):
            if v >= low:
                out.append(struct.pack(">B" + fmt, code, v))
                return
        raise OverflowError(f"integer {v} out of msgpack's range")


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype, bytes))``."""
    out: List[bytes] = []
    _pack(out, [int(d) for d in shape])
    _pack(out, dtype_name)
    _pack(out, data)
    return b"".join([bytes([0x93])] + out)


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n]]))
    else:
        _header(out, n, 0, 0, _EXT)
    out.append(struct.pack("b", code))
    out.append(data)


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xA0, 32, _STR)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), 0, 0, _BIN)
        out.append(bytes(obj))
    elif isinstance(obj, list):
        _header(out, len(obj), 0x90, 16, _ARRAY)
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, _MAP)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, torch.Tensor):  # bfloat16 only (see _state)
        data = obj.contiguous().view(torch.int16).numpy().tobytes()
        _ext(out, _EXT_NDARRAY, _array_payload(obj.shape, "bfloat16", data))
    elif isinstance(obj, np.ndarray):
        _check_dtype(obj.dtype)
        _ext(out, _EXT_NDARRAY,
             _array_payload(obj.shape, obj.dtype.name, obj.tobytes("C")))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        _check_dtype(arr.dtype)
        _ext(out, _EXT_NPSCALAR,
             _array_payload((), arr.dtype.name, arr.tobytes("C")))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} in a "
                        "checkpoint")


def _check_dtype(dtype: np.dtype) -> None:
    if dtype.hasobject or dtype.isalignedstruct:
        raise ValueError(f"dtype {dtype} cannot be serialized")


def _state(tree: Any) -> Any:
    """flax's ``to_state_dict`` on a tree: maps keep their keys as str,
    lists and tuples become maps keyed by position, named tuples maps
    keyed by field; tensors become numpy arrays (bfloat16 ones stay
    tensors, on the CPU)."""
    if isinstance(tree, dict):
        return {str(k): _state(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _state(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return tree


def _chunk(arr):
    """flax's ``_chunk``: the flat array in chunks of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i: i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk_leaves(d: Any) -> Any:
    if isinstance(d, dict):
        return {k: _chunk_leaves(v) for k, v in d.items()}
    if isinstance(d, (np.ndarray, torch.Tensor)) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree`` (a
    nested dict of arrays, tensors, scalars, lists and tuples)."""
    out: List[bytes] = []
    _pack(out, _chunk_leaves(_state(tree)))
    return b"".join(out)


# ---- decoding ------------------------------------------------------------

_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALARS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_FIXEXT_LEN = {code: n for n, code in _FIXEXT.items()}
#: type byte -> (kind, struct format of its length)
_SIZED = {code: (kind, ">" + fmt)
          for kind, codes in (("str", _STR), ("bin", _BIN), ("array", _ARRAY),
                              ("map", _MAP), ("ext", _EXT))
          for code, fmt in codes}


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads the array payload so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos: self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def obj(self) -> Any:
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map_(b & 0x0F)
        if b < 0xA0:
            return [self.obj() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self.str_(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT_LEN:
            return self.ext(_FIXEXT_LEN[b])
        if b not in _SIZED:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        kind, fmt = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.str_(n)
        if kind == "array":
            return [self.obj() for _ in range(n)]
        if kind == "map":
            return self.map_(n)
        return self.ext(n)

    def map_(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        arr = _array_from_payload(data)
        return arr if code == _EXT_NDARRAY else arr[()]


def _array_from_payload(data) -> Any:
    """flax's ``_ndarray_from_bytes``; bfloat16 as a torch tensor."""
    shape, dtype_name, buffer = _Reader(bytes(data), raw=True).obj()
    dtype_name = dtype_name.decode() if isinstance(dtype_name, bytes) \
        else dtype_name
    if dtype_name == "bfloat16":
        if not buffer:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buffer),
                                dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape)


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        return {k: _unchunk_leaves(v) for k, v in d.items()}
    return d


def msgpack_restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the nested dict of a flax
    msgpack file (a checkpoint, or a param tree from ``srsem convert``)."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         "msgpack object")
    return _unchunk_leaves(tree)


# ---- checkpoint directories ---------------------------------------------


def _step_files(directory: str) -> List[Tuple[int, str]]:
    """``(step, filename)`` of every ``step_<digits>.msgpack`` listed."""
    out = []
    for name in os.listdir(directory):
        mid = name[len("step_"):-len(".msgpack")]
        if name.startswith("step_") and name.endswith(".msgpack") \
                and mid.isdigit():
            out.append((int(mid), name))
    return sorted(out)


def save_checkpoint(directory: str, step: int, tree: Dict[str, Any],
                    keep_last: Optional[int] = None) -> str:
    """Write ``tree`` to ``directory/step_N.msgpack`` and point
    ``latest.json`` at it; returns the path.  As in the JAX package:
    ``latest.json`` is written to a temp file and ``os.replace``d;
    ``keep_last`` then keeps the newest N step files at or below ``step``,
    drops every step file above it (left by an earlier run in the same
    directory) and removes files by their listed names
    (``step_0010.msgpack`` is step 10), never the file just written."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack_serialize(tree))
    meta = os.path.join(directory, "latest.json")
    tmp = meta + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "path": path}, f)
    os.replace(tmp, meta)
    if keep_last is not None and keep_last > 0:
        entries = _step_files(directory)
        fresh = [e for e in entries if e[0] <= step]
        stale = [e for e in entries if e[0] > step]
        for _, name in stale + fresh[:-keep_last]:
            if name != f"step_{step}.msgpack":
                os.remove(os.path.join(directory, name))
    return path


def latest_step(directory: str) -> Optional[int]:
    """The step ``latest.json`` names; when it is corrupt, the largest step
    among the step files (None without a pointer or step files)."""
    meta = os.path.join(directory, "latest.json")
    if not os.path.exists(meta):
        return None
    try:
        with open(meta) as f:
            return int(json.load(f)["step"])
    except (ValueError, KeyError):
        steps = [s for s, _ in _step_files(directory)]
        return max(steps) if steps else None


def restore_checkpoint(directory: str,
                       step: Optional[int] = None) -> Dict[str, Any]:
    """The raw nested dict of step ``step`` (default: the latest), as the
    JAX package's ``restore_checkpoint(directory)`` with no target."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    with open(os.path.join(directory, f"step_{step}.msgpack"), "rb") as f:
        return msgpack_restore(f.read())
