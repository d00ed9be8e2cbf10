"""The parameter wire format, the port of
``surreal_tpu/distributed/module_dict.py`` (``ModuleDict``,
``dumps_pytree``, ``loads_pytree``), with ``host_tree``: a tree's
tensors copied to the host in one copy, for a publish that feeds both the
publisher and the parameter fanout.

The reference encodes a pytree with flax's msgpack. The port's format is
its own, and both ends of its wire are the port:

    b"SPTW" | u32 header length | header (JSON) | payload

The header lists every leaf by its path (``utils/tree.py``'s paths):
its path and, for a tensor, its dtype name, shape, offset and byte count
in the payload; a Python scalar or None travels in the header as its
value. The payload holds each tensor's raw bytes in the machine's order
(little-endian on every machine the port runs on), each at an offset
aligned to 16 bytes. No pickle and no msgpack: bytes from a socket are
decoded by the header alone.

Encoding copies every tensor leaf of the tree into one byte buffer on its
device and that buffer to the host once: the one device-to-host copy (one
sync) of a publish. bfloat16 and the other dtypes numpy lacks travel as
their bytes. Decoding copies the payload to the template's device once
and restores each leaf, by path, in the template's structure, dtype and
shape (a dict's key order may differ between the ends); a
path, dtype or shape that differs from the template's, or a tensor where
the template has a scalar (or the reverse), raises ``ValueError``.
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Any

import torch

from surreal_tpu_torch.utils.tree import tree_flatten, tree_unflatten

MAGIC = b"SPTW"
_HEADER_LEN = struct.Struct("<I")
_ALIGN = 16

if sys.byteorder != "little":  # the payload is the tensors' memory as it is
    raise ImportError("the parameter wire format assumes a little-endian machine")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def dumps_pytree(tree: Any) -> bytes:
    """``tree`` (NamedTuples, dicts, lists of tensors, Python scalars and
    None) as wire bytes."""
    leaves, chunks, offset = [], [], 0
    for path, x in tree_flatten(tree).items():
        if isinstance(x, torch.Tensor):
            n = x.numel() * x.element_size()
            leaves.append({"path": path, "dtype": _dtype_name(x.dtype), "shape": list(x.shape),
                           "offset": offset, "nbytes": n})
            pad = -n % _ALIGN
            chunks.append(x.detach().contiguous().reshape(-1).view(torch.uint8))
            if pad:
                chunks.append(torch.zeros(pad, dtype=torch.uint8, device=x.device))
            offset += n + pad
        elif x is None or isinstance(x, (bool, int, float)):
            leaves.append({"path": path, "value": x})
        else:
            raise TypeError(f"leaf {path!r} of type {type(x).__name__} has no wire form")
    devices = {c.device for c in chunks}
    if len(devices) > 1:
        raise ValueError(f"the tree's tensors lie on several devices: {sorted(map(str, devices))}")
    payload = torch.cat(chunks).cpu().numpy().tobytes() if chunks else b""
    header = json.dumps({"leaves": leaves}).encode()
    return b"".join((MAGIC, _HEADER_LEN.pack(len(header)), header, payload))


def host_tree(tree: Any) -> Any:
    """``tree`` with every tensor leaf on the host, copied in one
    device-to-host transfer (one sync): the leaves' bytes side by side,
    each at a 16-byte-aligned offset, and each leaf a view of that
    buffer (on the host too: a snapshot)."""
    flat = tree_flatten(tree)
    tensors = {k: x for k, x in flat.items() if isinstance(x, torch.Tensor)}
    devices = {x.device for x in tensors.values()}
    if len(devices) > 1:
        raise ValueError(f"the tree's tensors lie on several devices: {sorted(map(str, devices))}")
    if not tensors:
        return tree
    device = next(iter(devices))
    chunks, offsets, offset = [], {}, 0
    for k, x in tensors.items():
        n = x.numel() * x.element_size()
        chunks.append(x.detach().contiguous().reshape(-1).view(torch.uint8))
        pad = -n % _ALIGN
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.uint8, device=device))
        offsets[k] = offset
        offset += n + pad
    buf = torch.cat(chunks).cpu()
    for k, x in tensors.items():
        n = x.numel() * x.element_size()
        flat[k] = buf[offsets[k]:offsets[k] + n].view(x.dtype).reshape(x.shape)
    return tree_unflatten(tree, flat)


def _header(data) -> tuple[list[dict], int]:
    if bytes(data[:len(MAGIC)]) != MAGIC:
        raise ValueError("not a parameter wire blob (bad magic)")
    (n,) = _HEADER_LEN.unpack_from(data, len(MAGIC))
    start = len(MAGIC) + _HEADER_LEN.size
    return json.loads(bytes(data[start:start + n]))["leaves"], start + n


def loads_pytree(template: Any, data: bytes) -> Any:
    """The tree encoded in ``data``, in ``template``'s structure, dtypes,
    shapes and device; raises ``ValueError`` where they differ."""
    leaves, start = _header(data)
    want = tree_flatten(template)
    got_paths = {leaf["path"] for leaf in leaves}
    if got_paths != set(want) or len(leaves) != len(want):
        raise ValueError(f"wire tree does not match the template: missing {sorted(set(want) - got_paths)}, "
                         f"unexpected {sorted(got_paths - set(want))}")
    devices = {x.device for x in want.values() if isinstance(x, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"the template's tensors lie on several devices: {sorted(map(str, devices))}")
    payload = None
    if devices:
        raw = torch.frombuffer(bytearray(data[start:]), dtype=torch.uint8) if len(data) > start else \
            torch.empty(0, dtype=torch.uint8)
        payload = raw.to(next(iter(devices)))
    flat = {}
    for leaf in leaves:
        path, t = leaf["path"], want[leaf["path"]]
        if "value" in leaf:
            if isinstance(t, torch.Tensor):
                raise ValueError(f"leaf {path!r}: a value on the wire, a tensor in the template")
            flat[path] = leaf["value"]
            continue
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"leaf {path!r}: a tensor on the wire, {type(t).__name__} in the template")
        if leaf["dtype"] != _dtype_name(t.dtype) or leaf["shape"] != list(t.shape):
            raise ValueError(f"leaf {path!r}: wire {leaf['dtype']}{leaf['shape']}, "
                             f"template {_dtype_name(t.dtype)}{list(t.shape)}")
        off, n = leaf["offset"], leaf["nbytes"]
        flat[path] = payload[off:off + n].view(t.dtype).reshape(t.shape)
    return tree_unflatten(template, flat)


class ModuleDict:
    """Named bundle of trees with one binary encoding."""

    def __init__(self, modules: dict[str, Any]):
        self.modules = dict(modules)

    def dumps(self) -> bytes:
        return dumps_pytree(self.modules)

    def loads(self, data: bytes) -> dict[str, Any]:
        """Restore into the structure, dtypes, shapes and devices of the
        current modules (the template)."""
        self.modules = loads_pytree(self.modules, data)
        return self.modules
