"""Read the JAX package's checkpoints without JAX, flax or msgpack.

``rmm_tpu/utils/checkpoint.py:192-224`` writes a checkpoint directory: one
flax-msgpack file per component of ``params`` (``node_encoder``,
``edge_encoder``, ``model``, ``decoder``; the pretrainer's ``edge_encoder``,
``model``, ``mcm_head``, ``lp_head``), ``extras`` (the other collections,
``batch_stats``), ``opt_state`` and ``meta.json`` with ``ckpt_format``.
:func:`read_checkpoint` turns such a directory into the nested numpy tree
``{"params": {component: ...}, "batch_stats": ...}`` that
``rmm_tpu_torch.convert.from_jax`` takes; the optimizer state is not read.

The decoder covers what ``flax.serialization.msgpack_serialize`` emits:
maps, arrays, strings, bins, ints, floats, nil and bools, and flax's ext
types (``flax.serialization._MsgpackExtType``): ``ndarray`` (1), a msgpack
array ``(shape, dtype name, C-order bytes)``; ``native_complex`` (2);
``npscalar`` (3), a 0-d ``ndarray``. A bfloat16 array (numpy has no such
type) decodes to float32 holding the same values, each bf16 bit pattern in
the high half of its float32. Refused by name: flax's chunked arrays (a
leaf over 2**30 bytes), orbax component directories (``--ckpt_backend
orbax``) and ``ckpt_format`` < 2, whose PNA ``post_nn`` min/max blocks
are swapped (``rmm_tpu/utils/checkpoint.py:25-31``).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np

#: the JAX package's checkpoint format this reader takes
CKPT_FORMAT = 2
#: flax.serialization._MsgpackExtType
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: (">B", self.bin), 0xC5: (">H", self.bin),
                 0xC6: (">I", self.bin), 0xD9: (">B", self.str),
                 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        raise ValueError(f"byte 0x{b:02x} starts no msgpack object")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return ndarray_from_bytes(payload)
        if code == EXT_NPSCALAR:
            return ndarray_from_bytes(payload)[()]
        if code == EXT_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one of flax's")


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data`` (all of it), flax's ext types
    decoded."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the object")
    return out


def ndarray_from_bytes(payload: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    shape, name, buf = unpackb(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _refuse_chunked(tree: Any, path: str) -> None:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            raise NotImplementedError(
                f"{path}: flax chunked arrays (a leaf over 2**30 bytes) "
                "are not ported yet")
        for k, v in tree.items():
            _refuse_chunked(v, f"{path}/{k}")


def read_component(path: str) -> Any:
    """One component file → its nested tree of numpy arrays."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax directory (--ckpt_backend orbax): orbax "
            "checkpoints are not ported yet; re-save it with the msgpack "
            "backend")
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    _refuse_chunked(tree, os.path.basename(path))
    return tree


def ckpt_format(ck_dir: str) -> int:
    """``meta.json``'s ``ckpt_format`` (1 where it is absent, as
    ``rmm_tpu/utils/checkpoint.py::check_ckpt_format`` reads it)."""
    try:
        with open(os.path.join(ck_dir, "meta.json")) as f:
            return int(json.load(f).get("ckpt_format", 1))
    except (OSError, ValueError):
        return 1


def read_checkpoint(ck_dir: str) -> dict:
    """A JAX checkpoint directory → ``{"params": {component: tree},
    <extras' collections>}``: every component file beside ``extras``,
    ``opt_state``, ``moco_state`` and ``meta.json``."""
    version = ckpt_format(ck_dir)
    if version < CKPT_FORMAT:
        raise ValueError(
            f"checkpoint {ck_dir} has format v{version} (< v{CKPT_FORMAT}): "
            "its PNA post_nn weights hold the min/max blocks in the order "
            "[mean, max, min, std], which today's aggregator reads swapped; "
            "it is not loaded")
    skip = {"extras", "opt_state", "moco_state", "meta.json", "best_m.json"}
    out: dict = {"params": {}}
    for name in sorted(os.listdir(ck_dir)):
        if name in skip:
            continue
        out["params"][name] = read_component(os.path.join(ck_dir, name))
    extras = os.path.join(ck_dir, "extras")
    if os.path.exists(extras):
        out.update(read_component(extras))
    return out
