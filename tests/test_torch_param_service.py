"""The port's parameter service (``distributed/param_service.py``), its
wire format (``distributed/module_dict.py``) and the REQ/REP and PUB/SUB
sockets under them (``distributed/sockets.py``), against the reference's
``tests/test_distributed.py`` cases and its ``surreal_tpu.distributed``:

- the wire round trip is bit-exact for float32, bfloat16, int32, bool
  and nested NamedTuple/dict trees, gives the leaves the reference's
  msgpack round trip gives for the same arrays, and restores onto the
  template's dtypes; a template that differs in path, shape or dtype
  raises;
- publish/fetch, the version probe, the version-conditional fetch, a
  server bound to several endpoints, and a sharded server that routes a
  client id to the same shard index as the reference's ``address_for``;
- a client whose reply is delayed past its timeout (the fault site
  ``param_service.reply``) recovers on its next fetch, and a subscriber
  that never reads does not block ``publish``.

Every socket wait has its own deadline."""

import time
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.distributed import ParameterPublisher as JaxParameterPublisher
from surreal_tpu.distributed import ShardedParameterServer as JaxShardedParameterServer
from surreal_tpu.distributed.module_dict import dumps_pytree as jax_dumps_pytree
from surreal_tpu.distributed.module_dict import loads_pytree as jax_loads_pytree
from surreal_tpu_torch.distributed import (
    ModuleDict,
    ParameterClient,
    ParameterPublisher,
    ParameterServer,
    ShardedParameterServer,
    dumps_pytree,
    loads_pytree,
)
from surreal_tpu_torch.distributed.sockets import Pub, Rep, Req, Sub
from surreal_tpu_torch.utils import faults


class Stats(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor


def _tree(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"trunk.0.weight": torch.randn(64, 17, generator=g).to(torch.bfloat16),
                   "head.bias": torch.randn(4, generator=g)},
        "obs_stats": Stats(torch.tensor(seed, dtype=torch.int32), torch.randn(17, generator=g)),
        "mask": torch.tensor([True, False, True]),
        "empty": torch.zeros(0, 3),
        "step": 7,
        "none": None,
    }


def _assert_bit_equal(a, b):
    from surreal_tpu_torch.utils.tree import tree_flatten

    fa, fb = tree_flatten(a), tree_flatten(b)
    assert list(fa) == list(fb)
    for k, x in fa.items():
        if isinstance(x, torch.Tensor):
            assert x.dtype == fb[k].dtype and x.shape == fb[k].shape, k
            assert torch.equal(x.view(torch.uint8) if x.dtype == torch.bool else x, fb[k].view(torch.uint8)
                               if x.dtype == torch.bool else fb[k]), k
        else:
            assert x == fb[k], k


def _fetch(client: ParameterClient, deadline_s: float = 5.0):
    """The first non-None fetch within the deadline."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        got = client.fetch(timeout_ms=1000)
        if got is not None:
            return got
        time.sleep(0.02)
    raise AssertionError("nothing fetched before the deadline")


def test_pytree_wire_roundtrip_is_bit_exact():
    tree, template = _tree(1), _tree(2)
    back = loads_pytree(template, dumps_pytree(tree))
    _assert_bit_equal(back, tree)
    assert isinstance(back["obs_stats"], Stats)
    # the reference's own round trip of the same float32 and int32 arrays
    # gives the same leaves (its msgpack format is its own; both ends of
    # each wire are one package)
    arrays = {"w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7, "n": np.array([3, -1], np.int32)}
    ref = jax_loads_pytree({k: jnp.zeros_like(v) for k, v in arrays.items()},
                           jax_dumps_pytree({k: jnp.asarray(v) for k, v in arrays.items()}))
    ours = loads_pytree({k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype) for k, v in arrays.items()},
                        dumps_pytree({k: torch.from_numpy(v) for k, v in arrays.items()}))
    for k in arrays:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(ours[k].numpy(), arrays[k])


def test_module_dict_named_bundles():
    md = ModuleDict({"actor": {"w": torch.ones(4)}, "critic": {"w": torch.zeros(2)}})
    md2 = ModuleDict({"actor": {"w": torch.zeros(4)}, "critic": {"w": torch.ones(2)}})
    restored = md2.loads(md.dumps())
    np.testing.assert_array_equal(restored["actor"]["w"].numpy(), 1.0)
    np.testing.assert_array_equal(restored["critic"]["w"].numpy(), 0.0)


@pytest.mark.parametrize("change", ["shape", "dtype", "path", "extra", "kind", "magic"])
def test_mismatched_template_raises(change):
    tree = _tree(1)
    blob = dumps_pytree(tree)
    template = _tree(2)
    if change == "shape":
        template["params"]["head.bias"] = torch.zeros(5)
    elif change == "dtype":
        template["params"]["trunk.0.weight"] = torch.zeros(64, 17)  # float32 where bfloat16 was sent
    elif change == "path":
        template["params"]["head.weight"] = template["params"].pop("head.bias")
    elif change == "extra":
        template["params"]["more"] = torch.zeros(1)
    elif change == "kind":
        template["step"] = torch.zeros(())
    else:
        blob = b"XXXX" + blob[4:]
    with pytest.raises(ValueError):
        loads_pytree(template, blob)


def test_publish_fetch_and_the_version_conditional_fetch():
    """Before a publish the server answers none; the fetch carries the
    client's version and an unchanged server answers without the blob
    (None, the version kept); a fresh client gets the blob; the version
    probe reads the newest version without fetching."""
    pub = ParameterPublisher()
    server = ParameterServer(pub.address)
    client = ParameterClient(server.address, template={"w": torch.zeros(3)})
    fresh = ParameterClient(server.address, template={"w": torch.zeros(3)})
    try:
        assert client.fetch(timeout_ms=2000) is None and client.peek_version(timeout_ms=2000) == 0
        assert pub.publish({"w": torch.full((3,), 4.0)}) == 1
        np.testing.assert_array_equal(_fetch(client)["w"].numpy(), 4.0)
        assert client.version == 1
        assert client.fetch(timeout_ms=2000) is None and client.version == 1
        np.testing.assert_array_equal(_fetch(fresh)["w"].numpy(), 4.0)
        pub.publish({"w": torch.full((3,), 5.0)})
        deadline = time.monotonic() + 5
        while client.peek_version(timeout_ms=2000) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert client.version == 1  # a probe fetches nothing
        np.testing.assert_array_equal(_fetch(client)["w"].numpy(), 5.0)
        assert client.version == 2
    finally:
        client.close()
        fresh.close()
        server.close()
        pub.close()


def test_server_multi_bind_serves_every_endpoint_and_reports_fetches():
    events = []
    pub = ParameterPublisher()
    server = ParameterServer(pub.address, bind=["tcp://127.0.0.1:*", "tcp://127.0.0.1:*"],
                             on_event=lambda kind, **f: events.append((kind, f)))
    clients = []
    try:
        assert len(server.addresses) == 2 and server.addresses[0] != server.addresses[1]
        pub.publish({"w": torch.full((2,), 3.0)})
        for addr in server.addresses:
            clients.append(ParameterClient(addr, template={"w": torch.zeros(2)}))
            np.testing.assert_array_equal(_fetch(clients[-1])["w"].numpy(), 3.0)
        clients[0].fetch(timeout_ms=2000)  # unchanged
        fetched = [f for kind, f in events if kind == "param_fetch"]
        assert [f["unchanged"] for f in fetched][-3:] == [False, False, True]
        assert all(f["version"] == 1 for f in fetched) and fetched[-2]["bytes"] > 0 and fetched[-1]["bytes"] == 0
    finally:
        for c in clients:
            c.close()
        server.close()
        pub.close()


def test_sharded_server_routes_as_the_reference_and_every_shard_serves():
    pub = ParameterPublisher()
    sharded = ShardedParameterServer(pub.address, num_shards=3)
    jax_pub = JaxParameterPublisher()
    jax_sharded = JaxShardedParameterServer(jax_pub.address, num_shards=3)
    clients = []
    try:
        ids = [f"eval-{i}" for i in range(64)] + ["actor-0", "", "ünïcode"]
        ours = [sharded.addresses.index(sharded.address_for(c)) for c in ids]
        theirs = [jax_sharded.addresses.index(jax_sharded.address_for(c)) for c in ids]
        assert ours == theirs and len(set(ours)) == 3
        pub.publish({"w": torch.full((2,), 9.0)})
        for addr in sharded.addresses:
            clients.append(ParameterClient(addr, template={"w": torch.zeros(2)}))
            np.testing.assert_array_equal(_fetch(clients[-1])["w"].numpy(), 9.0)
        with pytest.raises(ValueError):
            ShardedParameterServer(pub.address, num_shards=0)
        with pytest.raises(ValueError):
            ShardedParameterServer(pub.address, num_shards=2, binds=["tcp://127.0.0.1:*"])
    finally:
        for c in clients:
            c.close()
        sharded.close()
        pub.close()
        jax_sharded.close()
        jax_pub.close()


def test_client_recovers_after_a_delayed_reply():
    """``delay_reply`` holds the first reply 600 ms, past the client's
    100 ms timeout: the fetch raises TimeoutError (one attempt), the client
    replaces its REQ socket, and the next fetch gets the params; the late
    reply to the abandoned connection is dropped without wedging the
    server. A client with nobody bound times out on every attempt and
    never wedges either."""
    faults.configure([{"site": "param_service.reply", "kind": "delay_reply", "ms": 600, "at": 0, "times": 1}])
    pub = ParameterPublisher()
    server = ParameterServer(pub.address)
    client = ParameterClient(server.address, template={"w": torch.zeros(3)})
    nobody = ParameterClient("tcp://127.0.0.1:19", template={"w": torch.zeros(3)})
    try:
        pub.publish({"w": torch.full((3,), 2.0)})
        time.sleep(0.1)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError, match="1 attempt"):
            client.fetch(timeout_ms=100, retries=0)
        assert time.monotonic() - t0 < 1.0
        np.testing.assert_array_equal(_fetch(client)["w"].numpy(), 2.0)
        assert faults.drain_fired() == [{"site": "param_service.reply", "kind": "delay_reply", "call": 0}]
        for _ in range(2):
            with pytest.raises(TimeoutError, match="2 attempt"):
                nobody.fetch(timeout_ms=100, retries=1, backoff_s=0.01)
    finally:
        faults.configure(None)
        nobody.close()
        client.close()
        server.close()
        pub.close()


def test_a_stalled_subscriber_does_not_block_publish():
    """A subscriber that never reads, against 40 publishes of 4 MB: each
    publish returns at once, the publisher holds at most two messages for
    it (the one being written and the newest), and a live server beside it
    serves the newest version."""
    pub = ParameterPublisher()
    stalled = Sub()
    stalled.connect(pub.address)
    stalled.subscribe(b"params")
    server = ParameterServer(pub.address)
    client = ParameterClient(server.address, template={"w": torch.zeros(1 << 20)})
    try:
        time.sleep(0.2)
        worst = 0.0
        for i in range(40):
            t0 = time.perf_counter()
            pub.publish({"w": torch.full((1 << 20,), float(i))})
            worst = max(worst, time.perf_counter() - t0)
        assert worst < 0.5, f"a publish took {worst:.3f} s"
        assert pub._sock.pending() <= 2 * 2  # two subscribers, two messages each at most
        deadline = time.monotonic() + 10
        while client.peek_version(timeout_ms=2000) < 40 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert float(_fetch(client)["w"][0]) == 39.0 and client.version == 40
    finally:
        client.close()
        server.close()
        stalled.close()
        pub.close()


def test_req_rep_and_pub_sub_semantics():
    """REQ alternates strictly and reaches a server that binds while it
    waits; REP answers each peer and drops a reply to a peer that left;
    SUB gets only its topics, and a late subscriber gets the newest message
    of its topic at once."""
    rep = Rep()
    rep.bind("tcp://127.0.0.1:*")
    a, b = Req(), Req()
    a.connect(rep.address)
    b.connect(rep.address)
    try:
        a.send(b"from a")
        with pytest.raises(RuntimeError):
            a.send(b"again")
        assert not a.poll(50)  # the request goes out while a waits; no reply yet
        assert rep.poll(2000) and rep.recv() == b"from a"
        a.close()  # a gave up: its reply is dropped without blocking
        t0 = time.monotonic()
        rep.send_multipart([b"late", bytes(1 << 22)])
        assert time.monotonic() - t0 < 0.5
        b.send(b"from b")
        assert not b.poll(50)
        assert rep.poll(2000) and rep.recv() == b"from b"
        rep.send_multipart([b"to b", b"x"])
        assert b.poll(2000) and b.recv_multipart() == [b"to b", b"x"]
        assert not rep.poll(100)
        with pytest.raises(RuntimeError):
            rep.send_multipart([b"no request"])
    finally:
        a.close()
        b.close()
        rep.close()

    pub = Pub()
    pub.send_multipart([b"params", b"1"])
    pub.send_multipart([b"other", b"2"])
    late, other = Sub(), Sub()
    try:
        late.connect(pub.address)
        late.subscribe(b"par")
        assert late.poll(2000) and late.recv_multipart() == [b"params", b"1"]
        other.connect(pub.address)
        other.subscribe(b"nothing")
        pub.send_multipart([b"params", b"3"])
        assert late.poll(2000) and late.recv_multipart() == [b"params", b"3"]
        assert not other.poll(100)
    finally:
        late.close()
        other.close()
        pub.close()
