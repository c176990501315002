"""Bit-exact wire codec for migrated session state and tick rows, as
``fmda_tpu.fleet.state`` defines it.

Session migration's contract is *bit identity*: a session served on its
new owner must produce exactly the float stream it would have produced
unmigrated.  On the binary data plane (:mod:`fmda_tpu_torch.stream
.codec`) the state export moves **raw arrays**: dtype/shape/raw
IEEE bytes frames on a binary link, tagged base64 only when a link
negotiated down to the JSON fallback — either way no float→decimal→
float round trip, and the encode side is format-independent (the wire
layer lowers arrays per link at frame time).  The decoders also accept
the pre-v2 ``{"d", "sh", "b"}`` base64 envelope, so state exported by
an old peer (or parked in an old router's registry) still imports.

numpy only — this runs in the router process (bus-only host, no torch).
The bytes are the reference's (``fmda_tpu.fleet.state``) for the same
arrays.
"""

from __future__ import annotations

import base64
from typing import Optional, Union

import numpy as np

WireArray = Union[np.ndarray, dict]


def encode_array(a: np.ndarray) -> np.ndarray:
    """Array -> wire form: the contiguous array itself.  The transport
    codec carries it raw (binary links) or tagged base64 (JSON links);
    in-process buses pass it through untouched."""
    return np.ascontiguousarray(a)


def decode_array(d: WireArray) -> np.ndarray:
    """Wire form -> array.  Accepts the raw array (v2 wire, possibly a
    read-only view into a received frame — treat as immutable) and the
    legacy base64 envelope."""
    if isinstance(d, np.ndarray):
        return d
    a = np.frombuffer(base64.b64decode(d["b"]), dtype=np.dtype(d["d"]))
    return a.reshape(d["sh"]).copy()  # own the buffer (frombuffer is RO)


def encode_row(row: np.ndarray) -> np.ndarray:
    """A (F,) float32 tick row in wire form (the tick hot path).  The
    copy makes the outgoing queue own the row — the caller may reuse
    its buffer the moment submit returns."""
    return np.array(row, np.float32)


def decode_row(wire: Union[np.ndarray, str], n_features: int) -> np.ndarray:
    """Wire form -> (F,) float32 row; accepts the raw array (v2, a
    zero-copy view) and the legacy bare-base64 string."""
    if isinstance(wire, np.ndarray):
        row = np.asarray(wire, np.float32)
    else:
        row = np.frombuffer(base64.b64decode(wire), dtype=np.float32)
    if row.shape != (n_features,):
        raise ValueError(
            f"tick row decodes to shape {row.shape}, expected "
            f"({n_features},)")
    return row


def legacy_array(a: np.ndarray) -> dict:
    """Array -> the pre-v2 base64 envelope, bit-exact (raw bytes b64)."""
    a = np.ascontiguousarray(a)
    return {
        "d": a.dtype.str,
        "sh": list(a.shape),
        "b": base64.b64encode(a.tobytes()).decode("ascii"),
    }


def to_legacy(value):
    """Deep-lower every raw array in a wire value to the pre-v2 base64
    envelope.  Senders apply this on links that negotiated down to JSON
    (docs/multihost.md "Wire format v2"): the frame *encoding* already
    fell back at negotiation, but a genuinely pre-v2 peer also needs
    the pre-v2 payload *shapes* — v2 decoders accept both, so lowering
    on every JSON link is safe whatever the peer's age."""
    if isinstance(value, np.ndarray):
        return legacy_array(value)
    if isinstance(value, dict):
        return {k: to_legacy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [to_legacy(v) for v in value]
    return value


def legacy_tick(msg: dict) -> dict:
    """A v2 tick message in pre-v2 form: bare-base64 row (the old
    ``encode_row`` output — no envelope; both ends know the schema)."""
    out = dict(msg)
    out["row"] = base64.b64encode(
        np.ascontiguousarray(out["row"], np.float32).tobytes()
    ).decode("ascii")
    return out


def to_legacy_msgs(msgs) -> list:
    """Lower a router's outgoing batch for a JSON link: per-tick
    messages with base64 rows (no columnar blocks — an old worker has
    no ``tick_block`` handler) and enveloped arrays everywhere else
    (opens carry norm stats, forwarded migrations carry state)."""
    return [legacy_tick(m) if m.get("kind") == "tick" else to_legacy(m)
            for m in msgs]


def encode_norm(norm) -> Optional[dict]:
    """NormParams -> wire dict (None passes through: default stats)."""
    if norm is None:
        return None
    return {
        "x_min": encode_array(np.asarray(norm.x_min, np.float32)),
        "x_max": encode_array(np.asarray(norm.x_max, np.float32)),
    }


def decode_norm(msg: Optional[dict]):
    if msg is None:
        return None
    from fmda_tpu_torch.data.normalize import NormParams

    return NormParams(
        decode_array(msg["x_min"]), decode_array(msg["x_max"]))


def encode_param_tree(tree):
    """A checkpoint params tree (nested dicts/lists with array leaves)
    -> wire form: structure preserved, every leaf a contiguous array
    (raw on binary links; :func:`to_legacy` lowers per-link on JSON
    fallbacks).  numpy-only on purpose — the router broadcasts hot
    swaps without ever importing torch."""
    if isinstance(tree, dict):
        return {k: encode_param_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [encode_param_tree(v) for v in tree]
    return encode_array(np.asarray(tree))


def decode_param_tree(tree):
    """Wire form -> params tree.  A dict is a structure node unless it
    is the legacy ``{"d", "sh", "b"}`` base64 envelope — the only dict
    shape :func:`decode_array` accepts — so pre-v2 lowered trees decode
    to the same leaves bit-exact."""
    if isinstance(tree, dict):
        if set(tree.keys()) == {"d", "sh", "b"}:
            return decode_array(tree)
        return {k: decode_param_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [decode_param_tree(v) for v in tree]
    return decode_array(tree)


def encode_session_state(state: dict) -> dict:
    """:meth:`FleetGateway.export_session` output -> wire form."""
    out = {
        "carry": [
            [encode_array(part) for part in layer]
            for layer in state["carry"]
        ],
        "ring": encode_array(state["ring"]),
        "pos": int(state["pos"]),
        "x_min": encode_array(state["x_min"]),
        "x_range": encode_array(state["x_range"]),
        "seq": int(state["seq"]),
    }
    if state.get("tenant") is not None:
        # the QoS class migrates with the session (fmda_tpu.control);
        # pre-v2 decoders simply drop the extra key
        out["tenant"] = str(state["tenant"])
    return out


def decode_session_state(msg: dict) -> dict:
    """Wire form -> :meth:`FleetGateway.import_session` input."""
    out = {
        "carry": [
            [decode_array(part) for part in layer]
            for layer in msg["carry"]
        ],
        "ring": decode_array(msg["ring"]),
        "pos": int(msg["pos"]),
        "x_min": decode_array(msg["x_min"]),
        "x_range": decode_array(msg["x_range"]),
        "seq": int(msg["seq"]),
    }
    if msg.get("tenant") is not None:
        out["tenant"] = str(msg["tenant"])
    return out
