"""Shard-link plumbing shared by the sender and the sampler, the port of
``surreal_tpu/experience/link.py``: one reconnecting DEALER per shard
(``distributed/sockets.py::Dealer(reconnect=True)``) and ONE hello
negotiation routine.

The negotiation contract:

- every hello carries a per-attempt token the reply must echo: a stale
  grant from an earlier timed-out attempt is dropped, never attached
  (the shard unlinks superseded grants on its side);
- a granted shm slab is attached client-side (client-owned cleanup, the
  ``wire.create_slab`` rule); an attach failure degrades the link to the
  raw tcp codec, never to dead;
- a renegotiation that replaced the segment unlinks the orphan at once
  (a SIGKILLed shard cannot do it);
- success resets the link's dead/backoff state.

The DEALER reconnects by itself: a spawned shard that binds after its
clients were built, or a respawned one at the same address, is reached
without help; a link whose DEALER reconnected since its last
negotiation (``restarted``) re-negotiates in place before it sends again,
where the reference's zmq links wait for their ack or sample budgets to
run out. The port's ``sockets.Again`` and ``TimeoutError`` take the place
of ``zmq.Again`` and ``zmq.ZMQError``.
"""

from __future__ import annotations

import secrets
import time
from typing import Callable

from surreal_tpu_torch.distributed import sockets
from surreal_tpu_torch.experience import wire

SEND_TIMEOUT_S = 10.0  # a DEALER send the shard takes none of for this long raises (zmq's SNDTIMEO)


def shard_dealer(address: str, identity: str) -> sockets.Dealer:
    """A reconnecting DEALER to one shard server."""
    sock = sockets.Dealer(identity.encode(), SEND_TIMEOUT_S, reconnect=True)
    sock.connect(address)
    return sock


class ShardLinkBase:
    """One DEALER connection to one shard server: socket identity,
    negotiated transport/slab state, and the dead/backoff bookkeeping
    shared by sender and sampler links."""

    def __init__(self, address: str, shard_id: int, identity: str):
        self.address = address
        self.shard_id = shard_id
        self.sock = shard_dealer(address, identity)
        self.transport = "pickle"
        self.negotiated = False
        self.spec: wire.PlaneSpec | None = None
        self.slab = None
        self.views: list[dict] = []
        self.seq = 0
        self.dead = False
        self.failures = 0
        self.next_attempt = 0.0
        self.epoch = 0  # the DEALER's connection count at the last negotiation

    def restarted(self) -> bool:
        """True when the DEALER has reconnected since the last negotiation:
        the shard restarted (a respawn at the same address) and holds no
        state of this link, so the link must re-negotiate. The refresh
        notices a closed connection and makes the new one."""
        self.sock.refresh()
        return self.negotiated and self.sock.connects != self.epoch

    def on_slab(self, layout: wire.PlaneSlab) -> None:
        """Role hook: called with the granted slab layout after a
        successful shm attach (sender: seed the free-slot list; sampler:
        record the slot count)."""

    def schedule_backoff(self, base: float, cap: float) -> bool:
        """Mark dead and arm the next revival attempt (base * 2^k, capped:
        the SEED respawn schedule). Returns False so callers can
        ``return link.schedule_backoff(...)`` from their _mark_dead."""
        self.dead = True
        self.failures += 1
        self.next_attempt = time.monotonic() + min(cap, base * 2.0 ** (self.failures - 1))
        return False

    def revive_due(self) -> bool:
        """True when a dead link's backoff window has elapsed (an alive,
        negotiated link needs no revival)."""
        return not self.dead or time.monotonic() >= self.next_attempt

    def close(self) -> None:
        # client-owned slab cleanup (wire.create_slab's rule): unlink the
        # shard-created segment this link attached
        self.views = []
        wire.unlink_slab(self.slab)
        self.slab = None
        self.sock.close()


def negotiate_link(
    link: ShardLinkBase,
    send: Callable[[bytes], None],
    *,
    role: str,
    spec: wire.PlaneSpec | None,
    slot_rows: int,
    slots: int,
    mode: str,
    timeout_s: float,
    trace: str | None,
    stop_event=None,
    seq_base: int | None = None,
    force_tcp: bool = False,
    caps: tuple[str, ...] = (),
) -> dict | None:
    """Run the hello handshake on one link.

    ``send`` ships the payload on ``link.sock`` (the sender passes its
    fault-site and byte-counting ``_send_raw``; it may raise
    ``TimeoutError``). ``seq_base`` rides the hello when given (the
    sender's dedup re-base); ``force_tcp`` downgrades a resolved shm want
    (the FIFO sampler, whose chunk layouts are only known in-frame).
    Returns the shard's reply dict on success (transport resolved, slab
    attached or replaced, dead/backoff state reset), or None: the caller
    marks the link dead under its own backoff and accounting rules."""
    token = secrets.token_hex(4)
    want = wire.resolve_transport(mode, link.address)
    if force_tcp and want == "shm":
        want = "tcp"
    if want == "pickle":
        msg = {
            "kind": "hello", "role": role,
            "spec": spec.to_json() if spec else None,
            "slot_rows": int(slot_rows), "slots": int(slots),
            "transport": "pickle", "trace": trace, "token": token,
            "caps": sorted(caps),
        }
        if seq_base is not None:
            msg["seq_base"] = int(seq_base)
        payload = wire.encode_pickle_msg(msg)
    else:
        payload = wire.encode_hello(
            role, spec, slot_rows, slots, want,
            trace=trace, token=token, seq_base=seq_base or 0, caps=caps,
        )
    try:
        send(payload)
    except (TimeoutError, OSError):
        return None
    deadline = time.monotonic() + timeout_s
    kind, obj = None, None
    while time.monotonic() < deadline:
        if stop_event is not None and stop_event.is_set():
            return None
        if not link.sock.poll(100):
            continue
        kind, obj = wire.decode_payload(link.sock.recv())
        if kind == "msg":
            kind = obj.get("kind", "?")
        if kind in ("hello_ok", "hello_no") and obj.get("token") == token:
            break
        # stray acks and stale grants from earlier attempts: dropped (the
        # shard unlinked any superseded slab)
        kind = None
    if kind != "hello_ok":
        return None  # timeout, stop, or an explicit hello_no
    granted = obj.get("transport", "tcp")
    old_slab = link.slab
    link.slab, link.views = None, []
    if granted == "shm":
        try:
            layout = wire.PlaneSlab.from_json(obj["slab"])
            link.slab = wire.attach_slab(obj["name"])
            link.views = layout.views(link.slab.buf)
            link.on_slab(layout)
        except (OSError, ValueError, KeyError):
            granted = "tcp"  # degraded, never dead: the raw codec always works
    link.transport = granted
    if old_slab is not None and (link.slab is None or old_slab.name != link.slab.name):
        # renegotiation replaced the segment: unlink the orphan now
        # (client-owned cleanup; a SIGKILLed shard cannot do it)
        wire.unlink_slab(old_slab)
    link.negotiated = True
    link.dead = False
    link.failures = 0
    link.epoch = link.sock.connects
    return obj
