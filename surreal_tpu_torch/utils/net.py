"""Small networking helpers of the host-side service planes, a copy of
``surreal_tpu/utils/net.py`` (``alloc_address``)."""

from __future__ import annotations

import socket


def alloc_address(host: str = "127.0.0.1") -> str:
    """Pick a free loopback port (bind, then close) for a FIXED service
    address: the parent allocates it up front, so a respawned replica
    binds the same endpoint and its clients reconnect in place, with no
    rendezvous service. The small window between the close and the
    replica's bind is accepted: a lost race surfaces as a bind failure
    and a supervised respawn."""
    with socket.socket() as s:
        s.bind((host, 0))
        return f"tcp://{host}:{s.getsockname()[1]}"
