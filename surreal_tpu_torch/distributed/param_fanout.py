"""Versioned parameter fanout, the port of
``surreal_tpu/distributed/param_fanout.py`` (``FanoutCodec``,
``ParameterFanout``, ``ParameterSubscriber``): the learner broadcasts
weight FRAMES over PUB/SUB instead of answering N fetches, one encode for
N subscribers, on the port's standard-library sockets
(``distributed/sockets.py``).

Frame arms (``session.publish.fanout``):

- **full f32**: every leaf's raw bytes in canonical order. Exact.
- **bf16 wire** (``wire='bf16'``): floating leaves cast to bfloat16 on the
  wire and back to f32 on receipt; the reconstruction is exactly the
  bf16-rounded value.
- **delta** (``delta=True``): frames carry ``params - shadow`` against the
  subscribers' acked version, zlib-compressed at level 1. The publisher
  keeps a SHADOW, the tree a subscriber rebuilds by applying its frames,
  and always deltas against it, so wire rounding never accumulates:
  shadow and subscriber stay bit-identical.

The frame is the reference's, byte for byte on the same leaves:
``MAGIC | <QQB (version, base_version, flags) | body``, flags
``F_DELTA``/``F_BF16``/``F_ZLIB``. Leaves are in the port's canonical
order, ``utils/tree.py::tree_flatten`` (the reference's is
``jax.tree.leaves``, which sorts dict keys; both ends of the port's wire
are the port). The codec is numpy on the host, on little-endian bytes;
bf16 goes through torch's cast, viewed as 16-bit integers. A leaf is
floating by numpy's rule, which for a bfloat16 leaf (a
``model.dtype=bfloat16`` trunk) says no, as it does under ml_dtypes: such
a leaf ships raw and full in every frame, never as a delta. (torch's and
ml_dtypes' f32 -> bf16 casts agree on finite values and -0.0; they differ
on NaN, which a publish never carries: the hooks skip a tripped window.)

Delivery and fallback:

- Subscribers ack the version they applied (PUSH -> the publisher's PULL;
  an ack that cannot go out at once is dropped). A publish deltas only
  when every fresh ack sits at the current shadow version; a stale or
  absent ack (a dropped frame, a new subscriber) re-keys the stream with
  a FULL frame.
- The PUB queues every frame in order for each subscriber, up to its
  high-water mark (zmq's PUB, not the parameter publisher's conflating
  one: a conflated delta is a missed base). A frame beyond the mark is
  dropped for that subscriber and counted (``wire_drops``).
- A subscriber that receives a delta whose base is not its version drops
  it, counts it (``stale_frames``) and raises ``needs_resync``; its owner
  catches up through :meth:`ParameterSubscriber.catch_up`, one
  ``ParameterClient.fetch`` against the session's ``ParameterServer``.

Fault site ``param.publish``: ``delay_publish`` stalls the broadcast;
``drop_frame`` swallows it on the wire (the re-key above recovers).
"""

from __future__ import annotations

import json
import struct
import time
import uuid
import zlib
from typing import Any, Sequence

import numpy as np
import torch

from surreal_tpu_torch.distributed.module_dict import host_tree
from surreal_tpu_torch.distributed.sockets import Again, Pub, Pull, Push, Sub
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.tree import tree_flatten, tree_unflatten

MAGIC = b"\xa5PF1"
_FRAME_HDR = struct.Struct("<QQB")  # version, base_version, flags
F_DELTA = 1
F_BF16 = 2
F_ZLIB = 4

TOPIC = b"frame"
BF16_BITS = np.dtype("<u2")  # a bfloat16 array as its 16-bit patterns
DEFAULT_HWM = 1000           # zmq's default send high-water mark


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (round to nearest even), as 16-bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).view(torch.int16).numpy() \
        .view(BF16_BITS)


def from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bfloat16 patterns -> float32, exactly."""
    return (np.asarray(bits, BF16_BITS).astype(np.uint32) << 16).view(np.float32)


def _host_leaf(x) -> tuple[np.ndarray, bool]:
    """A leaf as a host numpy array, and whether it is bfloat16 (then its
    16-bit patterns)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view(BF16_BITS), True
        return x.numpy(), False
    return np.asarray(x), False


def _leaves(tree: Any) -> list:
    """The tree's leaves in canonical order (None is no leaf, as in
    ``jax.tree.leaves``)."""
    return [x for x in tree_flatten(tree).values() if x is not None]


class FanoutCodec:
    """Frame encode and decode over one tree structure (the template's).
    Floating leaves ride the wire dtype; integer, bool and bfloat16 leaves
    always ship raw and FULL (a count's delta buys nothing and would
    break exactness)."""

    def __init__(self, template: Any):
        host = [_host_leaf(x) for x in _leaves(template)]
        self.template = template
        self.dtypes = [a.dtype for a, _ in host]
        self.bf16 = [is_bf16 for _, is_bf16 in host]
        self.shapes = [a.shape for a, _ in host]
        self.floating = [np.issubdtype(d, np.floating) and not b for d, b in zip(self.dtypes, self.bf16)]

    def _wire_dtype(self, i: int, wire: str) -> np.dtype:
        if wire == "bf16" and self.floating[i]:
            return BF16_BITS
        return self.dtypes[i]

    def _to_wire(self, i: int, x: np.ndarray, wire: str) -> np.ndarray:
        """Floating leaf ``i``'s float32 values in its wire dtype."""
        return to_bf16_bits(x) if wire == "bf16" else x.astype(self.dtypes[i])

    @staticmethod
    def _from_wire(x: np.ndarray, wire: str) -> np.ndarray:
        """A floating leaf's wire values as float32."""
        return from_bf16_bits(x) if wire == "bf16" else x.astype(np.float32)

    def encode(
        self,
        version: int,
        leaves: Sequence[np.ndarray],
        *,
        wire: str = "f32",
        base_version: int = 0,
        shadow: Sequence[np.ndarray] | None = None,
    ) -> tuple[bytes, list[np.ndarray]]:
        """One frame, and the post-frame shadow (what a subscriber that
        applies it holds). ``shadow`` given: a delta frame against it;
        absent: a full frame. ``leaves``: host arrays (bfloat16 leaves as
        their 16-bit patterns)."""
        flags = F_BF16 if wire == "bf16" else 0
        parts = []
        new_shadow: list[np.ndarray] = []
        for i, leaf in enumerate(leaves):
            arr = np.asarray(leaf)
            if not self.floating[i]:
                parts.append(np.ascontiguousarray(arr, self.dtypes[i]).tobytes())
                new_shadow.append(np.array(arr, self.dtypes[i]))
                continue
            f32 = np.asarray(arr, np.float32)
            if shadow is not None:
                delta = self._to_wire(i, f32 - shadow[i], wire)
                parts.append(np.ascontiguousarray(delta).tobytes())
                new_shadow.append(shadow[i] + self._from_wire(delta, wire))
            else:
                cast = self._to_wire(i, f32, wire)
                parts.append(np.ascontiguousarray(cast).tobytes())
                new_shadow.append(self._from_wire(cast, wire))
        body = b"".join(parts)
        if shadow is not None:
            flags |= F_DELTA | F_ZLIB
            body = zlib.compress(body, 1)
        frame = MAGIC + _FRAME_HDR.pack(int(version), int(base_version), flags) + body
        return frame, new_shadow

    def decode(self, frame: bytes, current: Sequence[np.ndarray] | None) -> tuple[int, int, list[np.ndarray] | None]:
        """(version, base_version, leaves or None): None for a delta the
        caller cannot apply (it holds no state)."""
        if frame[:4] != MAGIC:
            raise ValueError("not a parameter fanout frame")
        version, base_version, flags = _FRAME_HDR.unpack_from(frame, 4)
        body = frame[4 + _FRAME_HDR.size:]
        is_delta = bool(flags & F_DELTA)
        if is_delta and current is None:
            return version, base_version, None
        if flags & F_ZLIB:
            body = zlib.decompress(body)
        wire = "bf16" if flags & F_BF16 else "f32"
        leaves: list[np.ndarray] = []
        off = 0
        for i, shape in enumerate(self.shapes):
            wdt = self._wire_dtype(i, wire) if self.floating[i] else self.dtypes[i]
            n = int(np.prod(shape, dtype=np.int64))
            arr = np.frombuffer(body, wdt, count=n, offset=off).reshape(shape)
            off += n * wdt.itemsize
            if not self.floating[i]:
                leaves.append(np.array(arr))
            elif is_delta:
                leaves.append(current[i] + self._from_wire(arr, wire))
            else:
                leaves.append(self._from_wire(arr, wire))
        return version, base_version, leaves

    def to_tree(self, leaves: Sequence[np.ndarray]) -> Any:
        """Host leaves as torch CPU tensors in the template's structure
        (floating leaves float32, bfloat16 leaves bfloat16)."""
        flat = tree_flatten(self.template)
        it = iter(zip(leaves, self.bf16))
        for k, x in flat.items():
            if x is None:
                continue
            arr, is_bf16 = next(it)
            t = torch.from_numpy(np.array(arr))
            flat[k] = t.view(torch.bfloat16) if is_bf16 else t
        return tree_unflatten(self.template, flat)


class ParameterFanout:
    """Learner side: PUB for frames (queued, up to ``DEFAULT_HWM`` a
    subscriber), PULL for the subscribers' acks. One ``publish`` per cadence fire; the full or
    delta choice reads the freshest acks (see the module doc)."""

    def __init__(
        self,
        bind: str = "tcp://127.0.0.1:*",
        ack_bind: str = "tcp://127.0.0.1:*",
        wire: str = "f32",
        delta: bool = True,
        ack_ttl_s: float = 60.0,
    ):
        if wire not in ("f32", "bf16"):
            raise ValueError(f"fanout wire {wire!r} not in f32|bf16")
        self._pub = Pub(bind, hwm=DEFAULT_HWM)
        self.address = self._pub.address
        self._ack = Pull(ack_bind)
        self.ack_address = self._ack.address
        self.wire = wire
        self.delta = bool(delta)
        self.ack_ttl_s = float(ack_ttl_s)
        self.version = 0
        self._codec: FanoutCodec | None = None
        self._shadow: list[np.ndarray] | None = None
        self._shadow_version = 0
        self._acked: dict[str, tuple[int, float]] = {}  # id -> (version, time)
        # pinned-version holds: {version -> (refcount, full frame)}, so a
        # subscriber catching a pinned session up never needs the pinned
        # version to be the live one
        self._held: dict[int, tuple[int, bytes]] = {}
        self.frames = 0
        self.full_frames = 0
        self.delta_frames = 0
        self.rekeys = 0  # full frames forced by a stale or absent ack
        self.bytes_published = 0
        self.last_bytes = 0
        self._force_full = False  # one-shot: the next publish re-keys FULL

    def _drain_acks(self) -> None:
        while True:
            try:
                msg = self._ack.recv()
            except Again:
                return
            try:
                ack = json.loads(msg.decode())
                self._acked[str(ack["id"])] = (int(ack["version"]), time.monotonic())
            except (ValueError, KeyError, TypeError):
                continue  # a malformed ack: a subscriber's fault, not ours

    def _fresh_acks(self) -> list[int]:
        now = time.monotonic()
        return [v for v, t in self._acked.values() if now - t <= self.ack_ttl_s]

    @property
    def subscribers(self) -> int:
        return len(self._fresh_acks())

    @property
    def wire_drops(self) -> int:
        """Frames dropped at a subscriber's high-water mark."""
        return self._pub.dropped

    def publish(self, params: Any) -> dict:
        """Broadcast one version of ``params`` (device tensors are copied
        to the host in one copy; a view already on the host, as the
        session hooks pass, costs none); returns {version, bytes, kind}."""
        if any(isinstance(x, torch.Tensor) and x.device.type != "cpu" for x in tree_flatten(params).values()):
            params = host_tree(params)
        if self._codec is None:
            self._codec = FanoutCodec(params)
        self._drain_acks()
        self.version += 1
        leaves = [_host_leaf(x)[0] for x in _leaves(params)]
        acks = self._fresh_acks()
        want_delta = self.delta and self._shadow is not None and self._shadow_version == self.version - 1
        if want_delta and (not acks or min(acks) < self.version - 1):
            # a delta against a version some subscriber never acked falls
            # back to a FULL frame: a late joiner or a dropped frame must
            # not strand the stream on fetch fallbacks
            want_delta = False
            self.rekeys += 1
        elif want_delta and self._force_full:
            want_delta = False  # a requested re-key, counted as one
            self.rekeys += 1
        self._force_full = False
        if want_delta:
            frame, shadow = self._codec.encode(
                self.version, leaves, wire=self.wire, base_version=self._shadow_version, shadow=self._shadow,
            )
            kind = "delta"
            self.delta_frames += 1
        else:
            frame, shadow = self._codec.encode(self.version, leaves, wire=self.wire)
            kind = "full"
            self.full_frames += 1
        self._shadow = shadow
        self._shadow_version = self.version
        self.frames += 1
        self.last_bytes = len(frame)
        self.bytes_published += len(frame)
        f = faults.fire("param.publish")
        if f is not None:
            if f["kind"] == "delay_publish":
                faults.sleep_ms(f)
            elif f["kind"] == "drop_frame":
                # swallowed on the wire: the subscribers' acks go stale and
                # the next publish re-keys FULL
                return {"version": self.version, "bytes": len(frame), "kind": kind, "dropped": True}
        self._pub.send_multipart([TOPIC, frame])
        return {"version": self.version, "bytes": len(frame), "kind": kind}

    def force_rekey(self) -> None:
        """Make the next publish a FULL frame (counted in ``param/rekeys``)
        even when every ack is fresh."""
        self._force_full = True

    # -- pinned-version holds --------------------------------------------------
    def pin_version(self, version: int | None = None) -> int:
        """Hold ``version`` (default: the current one) as a decodable FULL
        frame until every pin on it is released. Only the current shadow
        can be snapshotted: a version the publisher has moved past raises
        ``KeyError`` unless it is held already (then its count goes up)."""
        v = self.version if version is None else int(version)
        held = self._held.get(v)
        if held is not None:
            self._held[v] = (held[0] + 1, held[1])
            return v
        if v != self.version or self._shadow is None or self._codec is None:
            raise KeyError(f"version {v} is not the current shadow ({self._shadow_version}) and holds no snapshot")
        frame, _ = self._codec.encode(v, self._shadow, wire=self.wire)
        self._held[v] = (1, frame)
        return v

    def release_pin(self, version: int) -> None:
        """Drop one pin on ``version``; the last release frees its frame.
        Releasing an unheld version does nothing."""
        v = int(version)
        held = self._held.get(v)
        if held is None:
            return
        if held[0] <= 1:
            del self._held[v]
        else:
            self._held[v] = (held[0] - 1, held[1])

    def held_frame(self, version: int) -> bytes | None:
        """The held full frame of a pinned version."""
        held = self._held.get(int(version))
        return held[1] if held is not None else None

    @property
    def holds(self) -> int:
        return len(self._held)

    def gauges(self) -> dict[str, float]:
        """The ``param/*`` gauges (``session/costs.py::GAUGE_REGISTRY``)."""
        return {
            "param/publishes": float(self.frames),
            "param/full_frames": float(self.full_frames),
            "param/delta_frames": float(self.delta_frames),
            "param/rekeys": float(self.rekeys),
            "param/bytes_last_publish": float(self.last_bytes),
            "param/bytes_published": float(self.bytes_published),
            "param/subscribers": float(self.subscribers),
            "param/holds": float(self.holds),
        }

    def close(self) -> None:
        self._pub.close()
        self._ack.close()


class ParameterSubscriber:
    """Replica or actor side: SUB for frames, PUSH for acks. Holds the
    rebuilt tree (host leaves) and its version; an inapplicable delta
    raises ``needs_resync``, and :meth:`catch_up` closes the gap through
    the fetch fallback."""

    def __init__(self, address: str, ack_address: str, template: Any, ident: str | None = None):
        self._sub = Sub()
        self._sub.connect(address)
        self._sub.subscribe(TOPIC)
        self._push = Push()
        self._push.connect(ack_address)
        self.ident = ident or uuid.uuid4().hex[:12]
        self.codec = FanoutCodec(template)
        self.template = template
        self._leaves: list[np.ndarray] | None = None
        self.version = 0
        self.applied = 0
        self.stale_frames = 0
        self.fallback_fetches = 0
        self.needs_resync = False

    @property
    def params(self) -> Any | None:
        """The rebuilt tree as torch CPU tensors in the template's
        structure (floating leaves float32), or None before the first
        frame or snapshot."""
        if self._leaves is None:
            return None
        return self.codec.to_tree(self._leaves)

    def _send_ack(self) -> None:
        # acks are advisory: one that cannot go out at once is dropped, and
        # the publisher's ttl handles the silence
        self._push.send(json.dumps({"id": self.ident, "version": self.version}).encode())

    def poll(self, timeout_ms: int = 0) -> Any | None:
        """Apply every waiting frame in order; the new tree when the
        version advanced, else None. An inapplicable delta (a missed frame,
        a fresh subscriber) sets ``needs_resync`` and is counted."""
        advanced = False
        deadline = time.monotonic() + timeout_ms / 1e3
        while True:
            if not self._sub.poll(0):
                if advanced or time.monotonic() >= deadline:
                    break
                self._sub.poll(max(1, int(timeout_ms / 4)))
                continue
            _, frame = self._sub.recv_multipart()
            version, base, leaves = self.codec.decode(frame, self._leaves)
            if leaves is None or (base and base != self.version):
                # a delta we cannot apply: count and flag, never guess
                self.stale_frames += 1
                self.needs_resync = True
                continue
            self._leaves = leaves
            self.version = version
            self.applied += 1
            self.needs_resync = False
            advanced = True
        if advanced:
            self._send_ack()
            return self.params
        return None

    def resync(self, params: Any, version: int) -> None:
        """Install a fetched snapshot (a late joiner, or after a gap) and
        re-enter the delta stream from its version."""
        leaves = []
        for x in _leaves(params):
            arr, is_bf16 = _host_leaf(x)
            leaves.append(np.asarray(arr, np.float32) if np.issubdtype(arr.dtype, np.floating) and not is_bf16
                          else arr)
        self._leaves = leaves
        self.version = int(version)
        self.needs_resync = False
        self._send_ack()

    def catch_up(self, client) -> bool:
        """Close a gap through the fetch fallback: one
        ``ParameterClient.fetch`` against the session's ParameterServer,
        counted. True when a snapshot was installed."""
        self.fallback_fetches += 1
        got = client.fetch()
        if got is None:
            # 'unchanged': the server sits at the client's version. Only a
            # subscriber that holds params may claim that position (its ack
            # re-keys the publisher off its true spot); a fresh one must not
            # ack a position it cannot apply deltas from
            if client.version and self._leaves is not None:
                self.version = int(client.version)
                self.needs_resync = False
                self._send_ack()
            return False
        self.resync(got, client.version)
        return True

    def gauges(self) -> dict[str, float]:
        return {
            "param/applied_frames": float(self.applied),
            "param/stale_frames": float(self.stale_frames),
            "param/fallback_fetches": float(self.fallback_fetches),
        }

    def close(self) -> None:
        self._sub.close()
        self._push.close()
