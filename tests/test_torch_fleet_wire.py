"""fmda_tpu_torch.fleet.wire against fmda_tpu.fleet.wire, on the CPU.

The port's ``SocketBus`` against the reference's ``BusServer``, and the
reference's ``SocketBus`` against the port's, over loopback, in both
dialects (the negotiated binary codec and the JSON fallback): the bus
contract (topics, monotonic offsets, independent consumers, batched ops
with per-op errors) holds across frameworks, arrays cross bit for bit, a
JSON-pinned peer and a binary peer share one served bus, the negotiation
settles as the reference's does, and a malformed frame is counted and
answered without killing the link.  The router folds result blocks that
either package packed.
"""

import socket
import struct

import numpy as np
import pytest

from fmda_tpu.fleet import wire as jax_wire
from fmda_tpu.obs.registry import MetricsRegistry as JaxRegistry
from fmda_tpu.stream import codec as jax_codec
from fmda_tpu.stream.bus import InProcessBus as JaxBus

from fmda_tpu_torch.fleet import wire
from fmda_tpu_torch.fleet.wire import (
    BufferedPublisher,
    BusServer,
    FrameDecodeError,
    SocketBus,
    parse_address,
)
from fmda_tpu_torch.obs.registry import MetricsRegistry
from fmda_tpu_torch.stream import codec
from fmda_tpu_torch.stream.bus import InProcessBus

TOPICS = ("alpha", "beta")
#: (server package, client package): each side of each link
PAIRS = [("jax", "port"), ("port", "jax")]
PKG = {
    "jax": dict(server=jax_wire.BusServer, client=jax_wire.SocketBus,
                bus=JaxBus, buffered=jax_wire.BufferedPublisher),
    "port": dict(server=BusServer, client=SocketBus, bus=InProcessBus,
                 buffered=BufferedPublisher),
}


@pytest.fixture(params=[(s, c, f) for s, c in PAIRS
                        for f in ("binary", "json")],
                ids=lambda p: f"{p[0]}-server-{p[1]}-client-{p[2]}")
def link(request):
    server_pkg, client_pkg, fmt = request.param
    bus = PKG[server_pkg]["bus"](TOPICS)
    server = PKG[server_pkg]["server"](bus).start()
    client = PKG[client_pkg]["client"].connect(server.address,
                                               wire_format=fmt)
    try:
        yield bus, server, client, fmt, client_pkg
    finally:
        client.close()
        server.stop()


def test_round_trip_and_consumers_across_frameworks(link):
    bus, server, cli, fmt, _ = link
    assert cli.negotiated_format == fmt
    assert cli.ping()
    assert tuple(cli.topics()) == TOPICS
    assert cli.publish("alpha", {"x": 1}) == 0
    assert cli.publish_many("alpha", [{"x": 2}, {"x": 3}]) == [1, 2]
    c = cli.consumer("alpha")
    assert [r.value["x"] for r in c.poll()] == [1, 2, 3]
    assert c.poll() == []
    late = cli.consumer("alpha", from_end=True)
    assert late.poll() == []
    bus.publish("alpha", {"x": 4})  # published server-side
    assert [r.value["x"] for r in late.poll()] == [4]
    assert cli.end_offset("alpha") == 4 and cli.end_offset("beta") == 0


def test_arrays_cross_bit_exact(link):
    bus, _, cli, _, _ = link
    rng = np.random.default_rng(0)
    row = rng.normal(size=108).astype(np.float32)
    block = rng.normal(size=(4, 6)).astype(np.float32)
    seqs = np.arange(4, dtype=np.int64)
    cli.publish("beta", {"kind": "tick", "row": row,
                         "nested": [{"b": block}, seqs], "f": 1.5,
                         "none": None, "s": "ñ", "raw": b"\x00\xff"})
    for rec in (cli.read("beta", 0)[0], bus.read("beta", 0)[0]):
        v = rec.value
        assert v["row"].dtype == np.float32
        np.testing.assert_array_equal(v["row"], row)
        np.testing.assert_array_equal(v["nested"][0]["b"], block)
        np.testing.assert_array_equal(v["nested"][1], seqs)
        assert (v["f"], v["none"], v["s"], bytes(v["raw"])) == (
            1.5, None, "ñ", b"\x00\xff")


def test_errors_cross_the_wire_and_the_link_survives(link):
    _, _, cli, _, _ = link
    with pytest.raises(KeyError):
        cli.publish("nope", {"x": 1})
    assert cli.publish("alpha", {"x": 1}) == 0


def test_batch_runs_ops_in_order_and_isolates_errors(link):
    _, _, cli, _, _ = link
    ops = [
        {"op": "publish_many", "topic": "alpha",
         "values": [{"i": 0}, {"i": 1}]},
        {"op": "publish", "topic": "nope", "value": {}},
        {"op": "read", "topic": "alpha", "offset": 0, "max_records": None},
    ]
    resps = cli.batch(ops)
    assert resps[0]["ok"] == [0, 1]
    assert resps[1]["kind"] == "KeyError"
    assert [v["i"] for _, v in cli.unwrap_op(ops[2], resps[2])] == [0, 1]


def test_buffered_publisher_across_frameworks(link):
    bus, _, cli, _, client_pkg = link
    pub = PKG[client_pkg]["buffered"](cli)
    pub.publish("alpha", {"i": 0})
    pub.publish_many("alpha", [{"i": 1}, {"i": 2}])
    pub.publish("beta", {"j": 0})
    pub.publish("alpha", {"i": 3})
    assert pub.pending == 5
    pub.flush()
    assert [r.value["i"] for r in bus.read("alpha", 0)] == [0, 1, 2, 3]
    assert [r.value["j"] for r in bus.read("beta", 0)] == [0]


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
@pytest.mark.parametrize("server_fmt,client_fmt,expect", [
    ("auto", "auto", "binary"), ("auto", "binary", "binary"),
    ("auto", "json", "json"), ("json", "auto", "json"),
    ("json", "binary", "json"), ("binary", "auto", "binary"),
])
def test_negotiation_matrix_across_frameworks(server_pkg, client_pkg,
                                              server_fmt, client_fmt,
                                              expect):
    server = PKG[server_pkg]["server"](PKG[server_pkg]["bus"](TOPICS),
                                       wire_format=server_fmt).start()
    try:
        cli = PKG[client_pkg]["client"].connect(server.address,
                                                wire_format=client_fmt)
        assert cli.negotiated_format == expect
        assert cli.publish("alpha", {"x": 1}) == 0
        assert cli.read("alpha", 0)[0].value == {"x": 1}
        cli.close()
    finally:
        server.stop()


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_json_peer_and_binary_peer_of_each_package_share_a_bus(server_pkg):
    server = PKG[server_pkg]["server"](PKG[server_pkg]["bus"](TOPICS)).start()
    try:
        clients = [PKG[p]["client"].connect(server.address, wire_format=f)
                   for p in ("jax", "port") for f in ("auto", "json")]
        row = np.arange(8, dtype=np.float32) / 3.0
        for i, cli in enumerate(clients):
            cli.publish("alpha", {"kind": "tick", "row": row * (i + 1)})
        for cli in clients:
            got = cli.read("alpha", 0)
            for i, rec in enumerate(got):
                assert rec.value["row"].dtype == np.float32
                np.testing.assert_array_equal(rec.value["row"],
                                              row * (i + 1))
        for cli in clients:
            cli.close()
    finally:
        server.stop()


def _raw_frame(payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + payload


def test_port_server_answers_malformed_frames_and_keeps_serving():
    server = BusServer(InProcessBus(TOPICS)).start()
    try:
        sock = socket.create_connection(
            tuple(parse_address(server.address)), timeout=30)
        io = wire._FrameIO(sock)
        sock.sendall(_raw_frame(b"this is not a frame"))
        assert io.recv_frame()["kind"] == "FrameDecodeError"
        sock.sendall(_raw_frame(jax_codec.encode({"op": "ping"})[:-3]))
        assert io.recv_frame()["kind"] == "FrameDecodeError"
        io.send_frame({"op": "ping"})
        assert io.recv_frame() == {"ok": "pong"}
        assert server.frame_stats()["malformed"] == 2
        sock.close()
    finally:
        server.stop()


def test_port_client_surfaces_a_malformed_response_without_killing_link():
    server = jax_wire.BusServer(JaxBus(TOPICS)).start()
    cli = SocketBus.connect(server.address, wire_format="json")
    try:
        cli._io._buf += _raw_frame(b"\xfb\x63garbage")
        with pytest.raises(FrameDecodeError):
            cli.ping()
        assert cli.frame_stats()["malformed"] == 1
        assert cli.ping()
    finally:
        cli.close()
        server.stop()


def test_wire_metrics_match_the_references_families():
    """``bind_metrics`` books the same frame counters and gauge names as
    the reference's, for the same traffic."""
    def families(client_cls, registry_cls):
        server = jax_wire.BusServer(JaxBus(TOPICS)).start()
        cli = client_cls.connect(server.address, wire_format="auto")
        try:
            reg = registry_cls()
            cli.bind_metrics(reg)
            cli.publish("alpha", {"x": 1})
            cli.read("alpha", 0)
            snap = reg.snapshot()
            return ({c["name"]: c["value"] for c in snap["counters"]
                     if c["name"].startswith("frames_")},
                    {g["name"]: g["value"] for g in snap["gauges"]})
        finally:
            cli.close()
            server.stop()

    assert families(SocketBus, MetricsRegistry) == families(
        jax_wire.SocketBus, JaxRegistry)


def test_parse_address_matches_the_reference():
    for text in ("10.0.0.1:9000", ":9000", "localhost:1"):
        assert parse_address(text) == jax_wire.parse_address(text)
    for bad in ("nope", "h:x"):
        with pytest.raises(ValueError):
            parse_address(bad)
        with pytest.raises(ValueError):
            jax_wire.parse_address(bad)


@pytest.mark.parametrize("packer", ["jax", "port"])
def test_router_folds_result_blocks_either_package_packed(packer):
    """A worker's columnar result block, packed by either package and
    crossing a port link, folds into the port router's per-tick results
    bit for bit; a malformed block is counted, never a crash."""
    from fmda_tpu_torch.config import DEFAULT_TOPICS, fleet_topics
    from fmda_tpu_torch.fleet.router import FleetRouter

    rng = np.random.default_rng(3)
    labels = ("up1", "up2", "down1", "down2")
    msgs = []
    for i in range(7):
        p = rng.random(4).astype(np.float32)
        msgs.append({"session": f"T{i % 3}", "seq": i,
                     "probabilities": [float(v) for v in p],
                     "pred_labels": [lab for lab, v in zip(labels, p)
                                     if v >= 0.5],
                     "prob_threshold": 0.5})
    block = (jax_codec if packer == "jax" else codec).pack_results(msgs,
                                                                   labels)
    block = codec.decode_payload(codec.encode_payload(block, binary=True))[0]
    router = FleetRouter(
        InProcessBus(tuple(DEFAULT_TOPICS) + fleet_topics(["w0"])),
        n_features=4)
    results = router._fold_results([(0, block)])
    assert len(results) == len(msgs)
    for res, want in zip(results, msgs):
        assert (res.session_id, res.seq, tuple(res.labels)) == (
            want["session"], want["seq"], tuple(want["pred_labels"]))
        np.testing.assert_array_equal(
            res.probabilities, np.asarray(want["probabilities"], np.float32))
    assert router.metrics.counters["results_unmatched"] == len(msgs)
    bad = dict(block)
    del bad["probs"]
    assert router._fold_results([(1, bad)]) == []
    assert router.metrics.counters["results_undecodable"] == 1
