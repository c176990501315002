"""fmda_tpu_torch.stream.codec against fmda_tpu.stream.codec: the port's
binary frames are the reference's, byte for byte, and each side decodes the
other's; the JSON fallback writes the same text.  Then the codec's own
properties in the port's terms (round trips, truncation, arrays, columnar
blocks, wire_copy).

The float rule: the binary format carries every float's bits, NaN payloads
included (bit equality); the JSON fallback writes a scalar NaN as ``NaN``,
so through it a scalar NaN comes back as a NaN, not necessarily with its
payload (canonical-NaN equality), while arrays keep their bits in both
formats.
"""

import json
import math
import struct

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # an image without the hypothesis wheel
    from _minihyp import given, settings, strategies as st

from fmda_tpu.stream import codec as ref

from fmda_tpu_torch.stream import codec

SETTINGS = dict(max_examples=40, deadline=None)


def _bits_eq(a, b, *, canonical_nan=False):
    """Structural equality with exact float identity (-0.0 != 0.0 on a
    bit-exact wire).  ``canonical_nan``: any NaN equals any NaN (the JSON
    fallback's rule for scalar floats)."""
    if isinstance(a, float) and isinstance(b, float):
        if canonical_nan and math.isnan(a) and math.isnan(b):
            return True
        return struct.pack("<d", a) == struct.pack("<d", b)
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, dict) and isinstance(b, dict):
        return (a.keys() == b.keys()
                and all(_bits_eq(v, b[k], canonical_nan=canonical_nan)
                        for k, v in a.items()))
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(
            _bits_eq(x, y, canonical_nan=canonical_nan) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


_SCALARS = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(min_value=-(2 ** 62), max_value=2 ** 62),
    st.floats(),  # unbounded: NaN (with payloads) and ±inf included
    st.just(-0.0),
    st.just(math.nan),
    st.text(),
    st.binary(max_size=16),
)

_VALUES = st.recursive(
    _SCALARS,
    lambda children: st.one_of(
        st.lists(children, max_size=6),
        st.dictionaries(st.text(max_size=8), children, max_size=6),
    ),
)


def _payload_nan():
    """A float NaN whose payload is not the canonical one."""
    return struct.unpack("<d", struct.pack("<Q", 0x7FF800000000BEEF))[0]


def _arrays():
    rng = np.random.default_rng(0)
    out = [(rng.standard_normal((3, 5)) * 100).astype(dt)
           for dt in (np.float32, np.float64, np.int32, np.int64, np.uint8,
                      np.bool_, np.float16)]
    out += [np.array([np.nan, np.inf, -np.inf, -0.0, 0.0,
                      np.finfo(np.float32).tiny], np.float32),
            np.zeros((0, 108), np.float32), np.zeros((4, 0), np.int64),
            np.arange(24, dtype=">i4").reshape(2, 3, 4),
            np.arange(12, dtype=np.float32).reshape(3, 4)[:, ::2]]
    return out


def _tick_msgs(n, feats=6, pool=4, trace_every=0):
    rng = np.random.default_rng(1)
    msgs = []
    for i in range(n):
        m = {"kind": "tick", "session": f"S{i % pool}",
             "row": rng.standard_normal(feats).astype(np.float32),
             "seq": 100 + i}
        if trace_every and i % trace_every == 0:
            m["trace"] = f"t{i}:s{i}"
        msgs.append(m)
    return msgs


def _result_msgs(n, version=None):
    rng = np.random.default_rng(2)
    labels = ("up1", "up2", "down1", "down2")
    msgs = []
    for i in range(n):
        p = rng.random(4).astype(np.float32)
        m = {"session": f"T{i % 3}", "seq": i,
             "probabilities": [float(v) for v in p],
             "pred_labels": [lab for lab, v in zip(labels, p) if v > 0.5],
             "prob_threshold": 0.5}
        if version is not None:
            m["weights_version"] = version
        if i % 2:
            m["trace"] = f"t{i}:s{i}"
        msgs.append(m)
    return msgs


def _fixed_values():
    """Values every wire path carries: scalars at their edges, a payload
    NaN, nested containers, arrays, and the three columnar blocks."""
    rows = [{"Timestamp": "2020-02-07 09:30:00", "Close": 1.5, "Vol": 2.0},
            {"Timestamp": "2020-02-07 09:31:00", "Close": -0.0,
             "Vol": 3.25, "Extra": "x"},
            {"Timestamp": "2020-02-07 09:32:00", "Close": math.inf,
             "Vol": 1e-300}]
    return ([None, True, False, 0, -(2 ** 63), 2 ** 63 - 1, 1.5, -0.0,
             math.inf, -math.inf, math.nan, _payload_nan(), "", "üñí",
             b"\x00\xff", {"a": [1, {"b": None}], "c": 2.5}, [[], {}]]
            + _arrays()
            + [{"a": a} for a in _arrays()]
            + [ref.pack_ticks(_tick_msgs(5, trace_every=2)),
               ref.pack_results(_result_msgs(6), ("up1", "up2", "down1",
                                                  "down2")),
               ref.pack_results(_result_msgs(4, version=3),
                                ("up1", "up2", "down1", "down2")),
               ref.pack_rows(rows)])


# ----------------------------------------------------- port against reference


@pytest.mark.parametrize("index", range(len(_fixed_values())))
def test_binary_frames_are_byte_identical_both_ways(index):
    value = _fixed_values()[index]
    frame = codec.encode(value)
    assert frame == ref.encode(value)
    assert _bits_eq(ref.decode(frame), codec.decode(frame))
    assert _bits_eq(codec.decode(ref.encode(value)), ref.decode(frame))


@given(value=_VALUES)
@settings(**SETTINGS)
def test_binary_frames_byte_identical_over_the_value_model(value):
    frame = codec.encode(value)
    assert frame == ref.encode(value)
    # the port reads the reference's frame and the reference the port's
    assert _bits_eq(codec.decode(ref.encode(value)), value)
    assert _bits_eq(ref.decode(frame), value)


@given(value=_VALUES)
@settings(**SETTINGS)
def test_json_fallback_text_is_the_references(value):
    text = codec.dumps(value)
    assert text == ref.dumps(value)
    assert _bits_eq(codec.loads(ref.dumps(value)), ref.loads(text),
                    canonical_nan=True)


def test_blocks_packed_by_either_side_are_the_same_frame():
    ticks = _tick_msgs(7, trace_every=3)
    results = _result_msgs(5, version=2)
    vocab = ("up1", "up2", "down1", "down2")
    rows = [{"Timestamp": "t", "x": 1.0}, {"Timestamp": "u", "x": 2.0}]
    for ours, theirs in (
            (codec.pack_ticks(ticks), ref.pack_ticks(ticks)),
            (codec.pack_results(results, vocab),
             ref.pack_results(results, vocab)),
            (codec.pack_rows(rows), ref.pack_rows(rows)),
            (codec.coalesce_ticks(ticks[:3] + [{"kind": "open"}] + ticks[3:]),
             ref.coalesce_ticks(ticks[:3] + [{"kind": "open"}] + ticks[3:]))):
        assert codec.encode(ours) == ref.encode(theirs)
    block = ref.decode(codec.encode(codec.pack_results(results, vocab)))
    assert [m["seq"] for m in ref.iter_results(block)] == list(range(5))


# ----------------------------------------------------- the codec's properties


def _round_trip(value, binary):
    payload = codec.encode_payload(value, binary=binary)
    out, was_binary = codec.decode_payload(payload)
    assert was_binary == binary
    return out


@given(value=_VALUES)
@settings(**SETTINGS)
def test_binary_round_trip_is_bit_identity(value):
    assert _bits_eq(_round_trip(value, binary=True), value)


@given(value=_VALUES)
@settings(**SETTINGS)
def test_json_fallback_round_trip_is_identity_up_to_canonical_nan(value):
    assert _bits_eq(_round_trip(value, binary=False), value,
                    canonical_nan=True)


def test_json_fallback_does_not_carry_a_scalar_nan_payload():
    """The rule the test above states, shown: the binary format keeps a
    payload NaN's bits, the JSON fallback keeps only that it is a NaN."""
    nan = _payload_nan()
    assert _bits_eq(_round_trip(nan, binary=True), nan)
    back = _round_trip(nan, binary=False)
    assert math.isnan(back) and not _bits_eq(back, nan)


@given(value=_VALUES)
@settings(**SETTINGS)
def test_truncated_buffer_always_rejected_never_misparsed(value):
    payload = codec.encode(value)
    step = max(1, len(payload) // 24)
    for cut in list(range(0, len(payload), step)) + [len(payload) - 1]:
        with pytest.raises(codec.CodecError):
            codec.decode(payload[:cut])


def test_trailing_garbage_bad_magic_version_and_tag_rejected():
    payload = codec.encode({"a": 1})
    with pytest.raises(codec.CodecError, match="trailing"):
        codec.decode(payload + b"\x00")
    with pytest.raises(codec.CodecError, match="magic"):
        codec.decode(b"\x00\x01\x00\x00")
    for pos, match in ((1, "version"), (2, "op"), (4, "tag")):
        bad = bytearray(codec.encode(None))
        bad[pos] = 0xEE if pos == 4 else 99
        with pytest.raises(codec.CodecError, match=match):
            codec.decode(bytes(bad))


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("index", range(len(_arrays())))
def test_array_dtype_shape_and_bits_preserved(binary, index):
    a = _arrays()[index]
    out = _round_trip({"a": a}, binary)["a"]
    assert out.dtype == a.dtype and out.shape == a.shape
    assert out.tobytes() == np.ascontiguousarray(a).tobytes()


def test_decoded_binary_array_is_zero_copy_readonly_view():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = codec.decode(codec.encode(a))
    assert not out.flags.writeable
    with pytest.raises((ValueError, RuntimeError)):
        out[0, 0] = 1.0
    assert np.array_equal(out, a)


def test_object_dtype_and_unknown_types_rejected_everywhere():
    a = np.array([object()], dtype=object)
    for fn in (codec.encode, codec.dumps, codec.wire_copy):
        with pytest.raises(codec.CodecError):
            fn(a)
    with pytest.raises(codec.CodecError, match="not wire-encodable"):
        codec.encode({"x": object()})
    with pytest.raises(codec.CodecError, match="i64"):
        codec.encode(2 ** 70)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("n", [2, 256])
def test_tick_block_round_trip_both_formats(binary, n):
    msgs = _tick_msgs(n, trace_every=3)
    back = list(codec.iter_ticks(_round_trip(codec.pack_ticks(msgs), binary)))
    assert [t[0] for t in back] == [m["session"] for m in msgs]
    assert [t[2] for t in back] == [m["seq"] for m in msgs]
    assert [t[3] for t in back] == [m.get("trace") for m in msgs]
    for t, m in zip(back, msgs):
        assert t[1].dtype == np.float32 and np.array_equal(t[1], m["row"])


def test_tick_block_rows_decode_into_one_contiguous_array():
    block = codec.decode(codec.encode(codec.pack_ticks(
        _tick_msgs(64, feats=108))))
    assert block["rows"].shape == (64, 108)
    assert block["rows"].flags.c_contiguous
    assert next(iter(codec.iter_ticks(block)))[1].base is not None


def test_coalesce_preserves_order_with_interleaved_control():
    ticks = _tick_msgs(6)
    msgs = (ticks[:3] + [{"kind": "open", "session": "S9"}] + ticks[3:5]
            + [{"kind": "close", "session": "S9"}] + ticks[5:])
    out = codec.coalesce_ticks(msgs)
    assert [m["kind"] for m in out] == [
        "tick_block", "open", "tick_block", "close", "tick"]
    seqs = []
    for m in out:
        if m["kind"] == "tick_block":
            seqs.extend(t[2] for t in codec.iter_ticks(m))
        elif m["kind"] == "tick":
            seqs.append(m["seq"])
    assert seqs == [t["seq"] for t in ticks]
    assert codec.coalesce_ticks([]) == []


@pytest.mark.parametrize("binary", [True, False])
def test_result_block_round_trip_is_the_per_tick_dialect(binary):
    msgs = _result_msgs(7, version=4)
    vocab = ("up1", "up2", "down1", "down2")
    back = list(codec.iter_results(_round_trip(
        codec.pack_results(msgs, vocab), binary)))
    for got, want in zip(back, msgs):
        assert got["session"] == want["session"]
        assert got["seq"] == want["seq"]
        assert got["pred_labels"] == want["pred_labels"]
        assert got["weights_version"] == 4
        assert got.get("trace") == want.get("trace")
        assert np.array_equal(np.asarray(got["probabilities"], np.float32),
                              np.asarray(want["probabilities"], np.float32))


def test_unpackable_result_runs_raise():
    vocab = ("up1", "up2", "down1", "down2")
    mixed = _result_msgs(2)
    mixed[1]["prob_threshold"] = 0.7
    with pytest.raises(codec.CodecError, match="threshold"):
        codec.pack_results(mixed, vocab)
    mixed = _result_msgs(2, version=1)
    mixed[1]["weights_version"] = 2
    with pytest.raises(codec.CodecError, match="weights_version"):
        codec.pack_results(mixed, vocab)
    with pytest.raises(codec.CodecError, match="vocabulary"):
        codec.pack_results(_result_msgs(1), [f"l{i}" for i in range(70)])


def test_pack_rows_round_trip_with_mixed_and_missing_keys():
    rows = _fixed_values()[-1]
    back = codec.unpack_rows(codec.decode(codec.encode(rows)))
    want = ref.unpack_rows(rows)
    assert len(back) == len(want) == 3
    for a, b in zip(back, want):
        assert _bits_eq(a, b)
    assert codec.unpack_rows(codec.decode(codec.encode(
        codec.pack_rows([])))) == []


def test_wire_copy_decouples_containers_coerces_and_passes_arrays():
    a = np.arange(4, dtype=np.float32)
    src = {"x": [1, 2], "a": a, "t": (1, 2)}
    out = codec.wire_copy(src)
    src["x"].append(3)
    assert out["x"] == [1, 2] and out["t"] == [1, 2] and out["a"] is a
    out = codec.wire_copy({1: np.float64(2.5)})
    assert out == {"1": 2.5} and type(out["1"]) is float
    assert codec.wire_copy({True: "x", None: "y"}) == {
        "true": "x", "null": "y"}
    with pytest.raises(codec.CodecError):
        codec.wire_copy({"bad": object()})


def test_json_fallback_is_plain_json_and_detection_is_per_frame():
    a = np.arange(3, dtype=np.int64)
    doc = json.loads(codec.dumps({"a": a, "n": 1}))
    assert doc["a"]["__nd__"][0] == a.dtype.str
    v = {"x": 1}
    assert codec.decode_payload(codec.encode_payload(v, binary=True)) == (
        v, True)
    assert codec.decode_payload(codec.encode_payload(v, binary=False)) == (
        v, False)
    with pytest.raises(codec.CodecError):
        codec.loads(b"not json at all")


def test_malformed_utf8_dict_key_is_a_codec_error():
    patched = codec.encode({"ab": 1}).replace(b"ab", b"\xff\xfe")
    with pytest.raises(codec.CodecError):
        codec.decode(patched)
