"""Experience wire codec, the port of ``surreal_tpu/experience/wire.py``:
the frame layouts (``MAGIC``, the struct headers, the spec's canonical
field order), ``PlaneSpec``, ``PlaneSlab``, every ``encode_*`` and
``decode_payload``, the slab lifecycle and the transport resolution.

Three negotiated arms, chosen per peer at a hello handshake:

- **shm**: same-host peers get a shard-created shared-memory slab
  (``PlaneSlab``: 64-byte-aligned per-slot field layout from the
  negotiated :class:`PlaneSpec`); the wire then carries only control
  frames ("slot k holds n rows");
- **tcp**: the length-framed raw codec, a struct header and then the rows
  packed field by field in the spec's canonical order;
- **pickle**: the per-peer fallback, whole messages as pickled dicts.
  ``pickle`` is imported by this module only (``tests/test_torch_hygiene.py``
  checks it).

What differs from the reference, by design:

- SAMPLE frames carry one little-endian uint64 seed per drawn set in the
  8 bytes the reference gives each JAX key's data, so the frame sizes are
  the same (``experience/sampler.py`` derives the seeds, ``shard.py``
  draws from them);
- bfloat16 fields: the reference's numpy dtype is ml_dtypes' bfloat16,
  which JSON names ``"<V2"`` (its ``dtype.str``). The port writes and
  reads the same string, so hello frames are byte-equal, and moves the
  bytes as ``uint16`` (``PlaneSpec.bf16`` names those fields; the torch
  side views them as ``int16`` and back to ``bfloat16`` on the card).
  ml_dtypes is not imported;
- slab names begin ``surreal_pt_xp_`` (the reference's ``surreal_xp_``),
  so neither package's leak checks see the other's segments.

Delivery: INSERT frames carry a per-peer ``seq`` and are acked; the
sender resends unacked frames and the shard deduplicates by seq
(at-least-once delivery, exactly-once ingestion). SAMPLE requests are
idempotent reads; PRIO frames are fire-and-forget.
"""

from __future__ import annotations

import json
import os
import pickle
import secrets
import struct
from multiprocessing import shared_memory
from typing import Any, Mapping, Sequence

import numpy as np

# Control frames are single wire messages prefixed with MAGIC; pickled dicts
# (protocol 5 starts b"\x80\x05") can never collide with it, so one
# payload sniff routes all three transports through the same server loop.
MAGIC = b"\xa5XP1"
XHELLO = 1
XHELLO_OK = 2
XHELLO_NO = 3
INSERT = 4
INSERT_OK = 5
SAMPLE = 6
SAMPLE_OK = 7
PRIO = 8
STATS = 9
STATS_OK = 10
POP = 11      # FIFO chunk-relay pop (SEED arm)
POP_OK = 12

# header structs (after MAGIC + kind byte)
_INS_HDR = struct.Struct("<IIHBd")    # seq, n_rows, slot, flags, t_send
_INSOK_HDR = struct.Struct("<IQ")     # seq, ingested_rows (ack watermark)
# SAMPLE carries nkeys draw seeds (the sample_many discipline on the wire:
# one frame per shard per iteration, the shard draws every index set);
# the key bytes are nkeys little-endian uint64 seeds, 8 bytes each, the
# size of the reference's JAX key data
_SMP_HDR = struct.Struct("<IIHQfHd")  # seq, bs, nkeys, watermark, beta,
#                                       base slot (u16: the sampler's slot
#                                       counter spans 2*updates_per_iter,
#                                       which overflows a u8), t_send
_SMPOK_HDR = struct.Struct("<IIHHB")  # seq, bs, nkeys, base slot, flags
_PRIO_HDR = struct.Struct("<IId")     # seq, n, t_send
_STATS_HDR = struct.Struct("<I")      # seq
_POP_HDR = struct.Struct("<IBd")      # seq, slot, t_send
_POPOK_HDR = struct.Struct("<III")    # seq, n, spec_len (0 = empty/no chunk)

# SAMPLE_OK flags
F_HAS_WEIGHTS = 1   # is-weights region/bytes are meaningful (prioritized)
F_SHM = 2           # rows live in the sampler's slab slot, not the frame

_ALIGN = 64  # slab field alignment (cache line), the shm_transport rule


BF16_WIRE = "<V2"  # the reference's JSON name of ml_dtypes.bfloat16 (its numpy dtype.str)
SEED_BYTES = 8     # one drawn set's seed in a SAMPLE frame


def _field_dtype(d) -> tuple[np.dtype, bool]:
    """(the numpy dtype that carries a field's bytes, whether it is
    bfloat16). ``d`` is a numpy dtype or name, a torch dtype, ``"bfloat16"``
    or the reference's ``"<V2"``."""
    name = str(d).removeprefix("torch.")
    if name in ("bfloat16", BF16_WIRE):
        return np.dtype(np.uint16), True
    return np.dtype(name if isinstance(d, str) or "torch." in str(d) else d), False


class PlaneSpec:
    """Canonical per-row transition layout: ordered (name, shape, dtype)
    fields shared by the packed tcp codec and the slab layout. Field order
    is sorted by name, so two processes that derive the spec from the same
    example agree byte for byte. ``bf16`` holds the names of the bfloat16
    fields, whose bytes travel as ``uint16``."""

    def __init__(self, fields: Sequence[tuple[str, Sequence[int], Any]]):
        self.fields = []
        self.bf16: set[str] = set()
        for n, s, d in sorted(fields, key=lambda f: f[0]):
            dtype, is_bf16 = _field_dtype(d)
            self.fields.append((str(n), tuple(int(x) for x in s), dtype))
            if is_bf16:
                self.bf16.add(str(n))
        self.row_nbytes = sum(
            int(np.prod(s, dtype=np.int64)) * d.itemsize for _, s, d in self.fields
        )

    @classmethod
    def from_example(cls, example: Mapping[str, Any]) -> "PlaneSpec":
        """Derive from one PER-ROW example dict {name: array or tensor}
        (leading batch dims stripped by the caller). Nested dicts flatten
        with '/' (``flatten_fields``)."""
        flat = flatten_fields(example)
        return cls([(k, tuple(v.shape), v.dtype) if hasattr(v, "dtype") else (k, np.shape(v), np.asarray(v).dtype)
                    for k, v in flat.items()])

    def names(self) -> list[str]:
        return [n for n, _, _ in self.fields]

    def _bytes_of(self, name: str, arr, dtype: np.dtype) -> np.ndarray:
        if name in self.bf16:
            arr = np.asarray(arr)
            if arr.dtype.itemsize != 2:
                raise ValueError(f"field {name!r} is bfloat16: pass its 16-bit words, got {arr.dtype}")
            return np.ascontiguousarray(arr).view(np.uint16)
        return np.ascontiguousarray(arr, dtype=dtype)

    def pack(self, batch: Mapping[str, np.ndarray], n: int) -> bytes:
        """Rows [n, ...] per field -> one contiguous bytes payload in
        canonical field order (the length-framed tcp codec body)."""
        parts = []
        for name, shape, dtype in self.fields:
            arr = self._bytes_of(name, batch[name], dtype)
            if arr.shape != (n, *shape):
                raise ValueError(f"field {name!r}: got {arr.shape}, want {(n, *shape)}")
            parts.append(arr.tobytes())
        return b"".join(parts)

    def unpack(self, buf, n: int) -> dict[str, np.ndarray]:
        """Inverse of :meth:`pack`. Returns arrays VIEWING ``buf``: callers
        that outlive the frame must copy (ring ingest copies by
        assignment)."""
        out = {}
        off = 0
        for name, shape, dtype in self.fields:
            count = n * int(np.prod(shape, dtype=np.int64))
            out[name] = np.frombuffer(buf, dtype, count=count, offset=off).reshape(n, *shape)
            off += count * dtype.itemsize
        return out

    def matches(self, other: "PlaneSpec") -> bool:
        return self.fields == other.fields and self.bf16 == other.bf16

    def to_json(self) -> list:
        return [[n, list(s), BF16_WIRE if n in self.bf16 else d.str] for n, s, d in self.fields]

    @classmethod
    def from_json(cls, data: list) -> "PlaneSpec":
        return cls([(n, s, d) for n, s, d in data])


def flatten_fields(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """One-level-recursive dict flatten with '/' keys (the SEED chunk's
    nested ``behavior`` dict crosses the wire flat)."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten_fields(v, prefix=f"{key}/"))
        else:
            out[key] = v
    return out


def unflatten_fields(flat: Mapping[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


class PlaneSlab:
    """Deterministic slab layout for one peer: ``slots`` slots, each
    holding the spec's fields (plus per-row ``extras`` like the sample
    reply's idx/is_weights) at fixed 64-byte-aligned offsets for
    ``slot_rows`` rows."""

    def __init__(
        self,
        spec: PlaneSpec,
        slot_rows: int,
        slots: int,
        extras: Sequence[tuple[str, Sequence[int], Any]] = (),
    ):
        self.spec = spec
        self.slot_rows = int(slot_rows)
        self.slots = int(slots)
        self.extras = [
            (str(n), tuple(int(d) for d in s), np.dtype(d))
            for n, s, d in extras
        ]
        self._layout: list[dict[str, tuple[int, tuple, np.dtype]]] = []
        off = 0
        for _ in range(self.slots):
            fields = {}
            for name, shape, dtype in [*spec.fields, *self.extras]:
                full = (self.slot_rows, *shape)
                nbytes = int(np.prod(full, dtype=np.int64)) * dtype.itemsize
                fields[name] = (off, full, dtype)
                off += (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
            self._layout.append(fields)
        self.nbytes = max(off, 1)

    def views(self, buf) -> list[dict[str, np.ndarray]]:
        out = []
        for fields in self._layout:
            out.append(
                {
                    name: np.ndarray(shape, dtype, buffer=buf, offset=off)
                    for name, (off, shape, dtype) in fields.items()
                }
            )
        return out

    def to_json(self) -> dict:
        return {
            "spec": self.spec.to_json(),
            "slot_rows": self.slot_rows,
            "slots": self.slots,
            "extras": [[n, list(s), d.str] for n, s, d in self.extras],
        }

    @classmethod
    def from_json(cls, d: dict) -> "PlaneSlab":
        return cls(
            PlaneSpec.from_json(d["spec"]), d["slot_rows"], d["slots"],
            extras=[(n, s, t) for n, s, t in d.get("extras", [])],
        )


SAMPLE_EXTRAS = (("_idx", (), np.uint32), ("_is_weights", (), np.float32))


# -- frame codec --------------------------------------------------------------

def encode_hello(role: str, spec: PlaneSpec | None, slot_rows: int,
                 slots: int, transport: str, trace: str | None = None,
                 token: str | None = None, seq_base: int = 0,
                 caps: Sequence[str] = ()) -> bytes:
    # token: per-attempt correlation nonce the reply must echo — a client
    # that retried its hello must not pair with the STALE attempt's grant
    # (the superseded slab would leak and, worse, the two sides would
    # read/write different segments)
    # seq_base: the sender's current seq at hello time — the shard
    # re-bases its exactly-once dedup floor on it (everything at or below
    # is settled or permanently dropped on the sender side)
    # caps: additive capability list: "lineage" declares the
    # sender's spec carries the lineage/* provenance columns. Peers read
    # it with .get — a pre-caps hello negotiates nothing extra and the
    # spec seam already makes unknown columns just more fields (never a
    # struct.error on mixed versions)
    return MAGIC + bytes([XHELLO]) + json.dumps(
        {
            "role": role,
            "spec": spec.to_json() if spec is not None else None,
            "slot_rows": int(slot_rows),
            "slots": int(slots),
            "transport": transport,
            "trace": trace,
            "token": token,
            "seq_base": int(seq_base),
            "pid": os.getpid(),
            "caps": sorted(caps),
        }
    ).encode()


def encode_hello_reply(transport: str | None, name: str | None = None,
                       slab: PlaneSlab | None = None, reason: str = "",
                       ingested_rows: int = 0,
                       token: str | None = None) -> bytes:
    if transport is None:
        return MAGIC + bytes([XHELLO_NO]) + json.dumps(
            {"reason": reason, "token": token}
        ).encode()
    return MAGIC + bytes([XHELLO_OK]) + json.dumps(
        {
            "transport": transport,
            "name": name,
            "slab": slab.to_json() if slab is not None else None,
            "pid": os.getpid(),
            "token": token,
            # the shard's current ingestion count: a re-negotiating sender
            # learns how much a RESPAWNED (empty) shard actually holds
            "ingested_rows": int(ingested_rows),
        }
    ).encode()


def encode_insert(seq: int, n: int, slot: int, flags: int = 0,
                  t_send: float = 0.0, body: bytes = b"") -> bytes:
    return (
        MAGIC + bytes([INSERT])
        + _INS_HDR.pack(seq & 0xFFFFFFFF, n, slot, flags, t_send)
        + body
    )


def encode_insert_ok(seq: int, ingested_rows: int) -> bytes:
    return MAGIC + bytes([INSERT_OK]) + _INSOK_HDR.pack(
        seq & 0xFFFFFFFF, int(ingested_rows)
    )


def encode_sample(seq: int, bs: int, watermark: int, beta: float,
                  slot: int, key_bytes: bytes, nkeys: int = 1,
                  t_send: float = 0.0) -> bytes:
    return (
        MAGIC + bytes([SAMPLE])
        + _SMP_HDR.pack(seq & 0xFFFFFFFF, bs, nkeys, int(watermark),
                        float(beta), slot, t_send)
        + key_bytes
    )


def encode_sample_ok(seq: int, bs: int, nkeys: int, slot: int, flags: int,
                     body: bytes = b"") -> bytes:
    return (
        MAGIC + bytes([SAMPLE_OK])
        + _SMPOK_HDR.pack(seq & 0xFFFFFFFF, bs, nkeys, slot, flags)
        + body
    )


def pack_sample_body(spec: PlaneSpec, results) -> bytes:
    """TCP sample reply body: per drawn set, idx u32[bs] + (optional)
    weights f32[bs] + packed rows, segments concatenated in key order."""
    parts = []
    for idx, weights, batch in results:
        n = int(idx.shape[0])
        parts.append(np.ascontiguousarray(idx, np.uint32).tobytes())
        if weights is not None:
            parts.append(np.ascontiguousarray(weights, np.float32).tobytes())
        parts.append(spec.pack(batch, n))
    return b"".join(parts)


def unpack_sample_body(spec: PlaneSpec, buf, bs: int, nkeys: int,
                       has_weights: bool):
    """Inverse of :func:`pack_sample_body` -> list of (idx, weights,
    rows-view-dict) per key (views over ``buf`` — callers copy)."""
    out = []
    off = 0
    mv = memoryview(buf)
    for _ in range(nkeys):
        idx = np.frombuffer(buf, np.uint32, count=bs, offset=off)
        off += 4 * bs
        weights = None
        if has_weights:
            weights = np.frombuffer(buf, np.float32, count=bs, offset=off)
            off += 4 * bs
        rows = spec.unpack(mv[off:], bs)
        off += bs * spec.row_nbytes
        out.append((idx, weights, rows))
    return out


def encode_prio(seq: int, idx: np.ndarray, prio: np.ndarray,
                t_send: float = 0.0) -> bytes:
    n = int(idx.shape[0])
    return (
        MAGIC + bytes([PRIO])
        + _PRIO_HDR.pack(seq & 0xFFFFFFFF, n, t_send)
        + np.ascontiguousarray(idx, np.uint32).tobytes()
        + np.ascontiguousarray(prio, np.float32).tobytes()
    )


def encode_stats(seq: int) -> bytes:
    return MAGIC + bytes([STATS]) + _STATS_HDR.pack(seq & 0xFFFFFFFF)


def encode_stats_reply(seq: int, stats: dict) -> bytes:
    return (
        MAGIC + bytes([STATS_OK]) + _STATS_HDR.pack(seq & 0xFFFFFFFF)
        + json.dumps(stats, default=float).encode()
    )


def encode_pop(seq: int, slot: int = 0, t_send: float = 0.0) -> bytes:
    return MAGIC + bytes([POP]) + _POP_HDR.pack(seq & 0xFFFFFFFF, slot, t_send)


def encode_pop_reply(seq: int, n: int, spec: PlaneSpec | None,
                     body: bytes = b"") -> bytes:
    """FIFO chunk reply: the chunk's own spec rides as JSON in the frame
    (chunk layouts are only known to the shard after the first insert, so
    the sampler cannot negotiate them at hello)."""
    spec_json = json.dumps(spec.to_json()).encode() if spec is not None else b""
    return (
        MAGIC + bytes([POP_OK])
        + _POPOK_HDR.pack(seq & 0xFFFFFFFF, n, len(spec_json))
        + spec_json
        + body
    )


def decode_payload(payload: bytes) -> tuple[str, Any]:
    """Route one plane frame -> (kind, obj). ``obj`` is the parsed JSON for
    hello frames, a header dict (with a ``body`` memoryview for
    raw-payload frames) for the rest, or the unpickled dict for 'msg' (the
    pickle fallback — deserialized HERE, the one place the experience
    plane may unpickle)."""
    if payload[:4] == MAGIC:
        kind = payload[4]
        body = memoryview(payload)[5:]
        if kind in (XHELLO, XHELLO_OK, XHELLO_NO):
            name = {XHELLO: "hello", XHELLO_OK: "hello_ok",
                    XHELLO_NO: "hello_no"}[kind]
            return name, json.loads(bytes(body).decode())
        if kind == INSERT:
            seq, n, slot, flags, t_send = _INS_HDR.unpack_from(body, 0)
            return "insert", {
                "seq": seq, "n": n, "slot": slot, "flags": flags,
                "t_send": t_send, "body": body[_INS_HDR.size:],
            }
        if kind == INSERT_OK:
            seq, rows = _INSOK_HDR.unpack_from(body, 0)
            return "insert_ok", {"seq": seq, "ingested_rows": rows}
        if kind == SAMPLE:
            seq, bs, nk, wm, beta, slot, t_send = _SMP_HDR.unpack_from(
                body, 0
            )
            return "sample", {
                "seq": seq, "bs": bs, "nkeys": nk, "watermark": wm,
                "beta": beta, "slot": slot, "t_send": t_send,
                "key": bytes(body[_SMP_HDR.size:]),
            }
        if kind == SAMPLE_OK:
            seq, bs, nk, slot, flags = _SMPOK_HDR.unpack_from(body, 0)
            return "sample_ok", {
                "seq": seq, "bs": bs, "nkeys": nk, "slot": slot,
                "flags": flags, "body": body[_SMPOK_HDR.size:],
            }
        if kind == PRIO:
            seq, n, t_send = _PRIO_HDR.unpack_from(body, 0)
            data = body[_PRIO_HDR.size:]
            idx = np.frombuffer(data, np.uint32, count=n)
            prio = np.frombuffer(data, np.float32, count=n, offset=4 * n)
            return "prio", {"seq": seq, "n": n, "t_send": t_send,
                            "idx": idx, "prio": prio}
        if kind == STATS:
            (seq,) = _STATS_HDR.unpack_from(body, 0)
            return "stats", {"seq": seq}
        if kind == STATS_OK:
            (seq,) = _STATS_HDR.unpack_from(body, 0)
            return "stats_ok", {
                "seq": seq,
                "stats": json.loads(bytes(body[_STATS_HDR.size:]).decode()),
            }
        if kind == POP:
            seq, slot, t_send = _POP_HDR.unpack_from(body, 0)
            return "pop", {"seq": seq, "slot": slot, "t_send": t_send}
        if kind == POP_OK:
            seq, n, spec_len = _POPOK_HDR.unpack_from(body, 0)
            off = _POPOK_HDR.size
            spec = None
            if spec_len:
                spec = PlaneSpec.from_json(
                    json.loads(bytes(body[off:off + spec_len]).decode())
                )
            return "pop_ok", {
                "seq": seq, "n": n, "spec": spec,
                "body": body[off + spec_len:],
            }
        raise ValueError(f"unknown experience frame kind {kind}")
    return "msg", pickle.loads(payload)


def encode_pickle_msg(msg: dict) -> bytes:
    """Fallback-transport message (whole dict, ndarray payloads included)."""
    return pickle.dumps(msg, protocol=5)


# -- slabs (client-owned cleanup) ---------------------------------------------

def create_slab(slab: PlaneSlab, tag: str = "") -> shared_memory.SharedMemory:
    """Shard-side: create a uniquely-named segment sized for ``slab``.

    Ownership inverts the SEED data plane's rule
    (``distributed/shm_transport.py``) for the reason it exists there:
    cleanup belongs to the LONG-LIVED side. There the server outlives
    SIGKILLable workers; here a fault plan may SIGKILL the
    shard, so the trainer-side plane owns every unlink — the shard
    unregisters its creator-side resource-tracker entry (process mode)
    while the attaching client KEEPS its registration, so even a crashed
    trainer's tracker still reaps the segment."""
    for _ in range(8):
        name = f"surreal_pt_xp_{tag}_{os.getpid()}_{secrets.token_hex(4)}"
        try:
            return shared_memory.SharedMemory(
                create=True, size=slab.nbytes, name=name
            )
        except FileExistsError:  # pragma: no cover - token collision
            continue
    raise RuntimeError("could not allocate a uniquely-named shm segment")


def untrack_slab(shm: shared_memory.SharedMemory) -> None:
    """Drop this process's resource-tracker registration for a segment
    another process owns the cleanup of (see :func:`create_slab`)."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except (ImportError, AttributeError, KeyError, OSError):
        # tracker API moved / registration absent on this interpreter —
        # worst case is a double-unlink warning at exit, never a leak
        # (the plane unlinks explicitly; shm_transport documents the same
        # narrow-except rationale)
        pass


def attach_slab(name: str) -> shared_memory.SharedMemory:
    """Client-side attach. The registration this makes in the client's
    resource tracker is KEPT deliberately: the client owns unlink (see
    :func:`create_slab`), and tracker-reaping is the crashed-client
    backstop."""
    return shared_memory.SharedMemory(name=name)


def unlink_slab(shm: shared_memory.SharedMemory | None) -> None:
    """Best-effort close + unlink (idempotent: the segment may already be
    gone if the owning tracker reaped it)."""
    if shm is None:
        return
    try:
        shm.close()
    except OSError:
        pass
    try:
        shm.unlink()
    except OSError:
        pass


def local_address(address: str) -> bool:
    """Shared memory only ever makes sense against a same-host peer."""
    return address.startswith(("ipc://", "inproc://")) or (
        "127.0.0.1" in address or "localhost" in address
    )


def resolve_transport(mode: str, address: str) -> str:
    """'auto' resolves by locality: shm same-host, the raw tcp codec
    cross-host. Explicit modes pass through."""
    if mode not in ("auto", "shm", "tcp", "pickle"):
        raise ValueError(f"transport {mode!r} not in auto|shm|tcp|pickle")
    if mode == "auto":
        return "shm" if local_address(address) else "tcp"
    return mode
