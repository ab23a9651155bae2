"""Malformed-input hardening of the rosbag reader.

First contact with real-world bags will hit truncated files, padded rows,
big-endian clouds, index records, and multi-connection topics; every failure
must surface as :class:`BagFormatError` (one line at the CLI), never a raw
``struct.error`` / ``KeyError`` / ``IndexError`` traceback.
"""

import struct

import numpy as np
import pytest

from randt_slam_tpu.io import rosbag as RB


def _write_minimal_bag(path, n_clouds=3, compression="none", topic="/radar"):
    rng = np.random.default_rng(0)
    msgs = []
    for t in range(n_clouds):
        pts = np.stack([rng.uniform(-20, 20, 40), rng.uniform(-20, 20, 40),
                        rng.uniform(0, 100, 40)], 1).astype(np.float32)
        msgs.append((topic, "sensor_msgs/PointCloud2", 10.0 + t * 0.25,
                     RB.serialize_pointcloud2(pts, 10.0 + t * 0.25)))
    RB.write_bag(str(path), msgs, compression=compression)
    return path


# ---------------------------------------------------------------------------
# truncation / corruption -> BagFormatError, never struct.error
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.9, 0.99])
def test_truncated_bag_raises_bag_format_error(tmp_path, cut):
    bag = _write_minimal_bag(tmp_path / "full.bag")
    blob = open(bag, "rb").read()
    cut_path = tmp_path / "cut.bag"
    cut_path.write_bytes(blob[: int(len(blob) * cut)])
    with pytest.raises(RB.BagFormatError):
        list(RB.read_messages(str(cut_path)))


def test_not_a_bag(tmp_path):
    p = tmp_path / "nope.bag"
    p.write_bytes(b"GIF89a not a bag at all")
    with pytest.raises(RB.BagFormatError):
        list(RB.read_messages(str(p)))


def test_byte_flip_fuzz_never_leaks_raw_exceptions(tmp_path):
    """Flip bytes all over a valid bag: each variant either parses or raises
    a typed error (BagFormatError / NotImplementedError for exotic
    compression tags) — no struct.error, KeyError, or IndexError."""
    bag = _write_minimal_bag(tmp_path / "full.bag")
    blob = bytearray(open(bag, "rb").read())
    rng = np.random.default_rng(7)
    p = tmp_path / "fuzz.bag"
    for trial in range(200):
        mutated = bytearray(blob)
        for _ in range(rng.integers(1, 4)):
            i = int(rng.integers(len(RB._MAGIC), len(mutated)))
            mutated[i] = int(rng.integers(0, 256))
        p.write_bytes(bytes(mutated))
        try:
            for m in RB.read_messages(str(p)):
                if m.msg_type.endswith("PointCloud2"):
                    RB.parse_pointcloud2(m.raw)
        except (RB.BagFormatError, NotImplementedError):
            pass  # typed, user-reportable
        # anything else (struct.error, KeyError, ...) fails the test


# ---------------------------------------------------------------------------
# layout variants the writer never produces but real bags do
# ---------------------------------------------------------------------------


def test_row_padded_pointcloud2():
    """height=2 organized cloud with row_step > point_step*width."""
    pts = np.arange(24, dtype=np.float32).reshape(8, 3)  # x,y,i rows
    width, height, step, pad = 4, 2, 12, 20
    row = step * width
    frame = b"radar"
    out = struct.pack("<IIII", 0, 1, 0, len(frame)) + frame
    out += struct.pack("<III", height, width, 3)
    for name, f_off in (("x", 0), ("y", 4), ("intensity", 8)):
        out += struct.pack("<I", len(name)) + name.encode()
        out += struct.pack("<IBI", f_off, 7, 1)
    out += struct.pack("<BII", 0, step, row + pad)
    body = b"".join(
        pts[r * width:(r + 1) * width].tobytes() + b"\0" * pad
        for r in range(height))
    out += struct.pack("<I", len(body)) + body + struct.pack("<B", 1)
    pc = RB.parse_pointcloud2(out)
    np.testing.assert_allclose(pc.points_xyi, pts)


def test_bigendian_pointcloud2():
    pts = np.asarray([[1.5, -2.0, 77.0], [0.25, 4.0, 3.0]], np.float32)
    frame = b"radar"
    out = struct.pack("<IIII", 0, 1, 0, len(frame)) + frame
    out += struct.pack("<III", 1, 2, 3)
    for name, f_off in (("x", 0), ("y", 4), ("intensity", 8)):
        out += struct.pack("<I", len(name)) + name.encode()
        out += struct.pack("<IBI", f_off, 7, 1)
    out += struct.pack("<BII", 1, 12, 24)        # is_bigendian=1
    body = pts.astype(">f4").tobytes()
    out += struct.pack("<I", len(body)) + body + struct.pack("<B", 1)
    pc = RB.parse_pointcloud2(out)
    np.testing.assert_allclose(pc.points_xyi, pts)


def test_pointcloud2_missing_xy_is_typed_error():
    frame = b"radar"
    out = struct.pack("<IIII", 0, 1, 0, len(frame)) + frame
    out += struct.pack("<III", 1, 1, 1)
    out += struct.pack("<I", 1) + b"z" + struct.pack("<IBI", 0, 7, 1)
    out += struct.pack("<BII", 0, 4, 4)
    out += struct.pack("<I", 4) + b"\0\0\0\0" + struct.pack("<B", 1)
    with pytest.raises(RB.BagFormatError, match="missing required field"):
        RB.parse_pointcloud2(out)


def test_index_records_are_skipped(tmp_path):
    """Bags written by the real rosbag API carry INDEX_DATA / CHUNK_INFO
    records after the chunks; the linear reader must skip them."""
    bag = _write_minimal_bag(tmp_path / "plain.bag")
    blob = bytearray(open(bag, "rb").read())
    idx_hdr = RB._encode_fields({
        "op": bytes([RB.OP_INDEX]), "ver": struct.pack("<I", 1),
        "conn": struct.pack("<I", 0), "count": struct.pack("<I", 1)})
    info_hdr = RB._encode_fields({
        "op": bytes([RB.OP_CHUNK_INFO]), "ver": struct.pack("<I", 1),
        "chunk_pos": struct.pack("<Q", 0),
        "count": struct.pack("<I", 1)})
    for hdr in (idx_hdr, info_hdr):
        blob += struct.pack("<I", len(hdr)) + hdr
        blob += struct.pack("<I", 12) + b"\0" * 12
    p = tmp_path / "indexed.bag"
    p.write_bytes(bytes(blob))
    msgs = list(RB.read_messages(str(p)))
    assert len(msgs) == 3
    for m in msgs:
        RB.parse_pointcloud2(m.raw)


def test_multiple_connections_per_topic(tmp_path):
    """rosbag splits a topic across connections when publishers differ; all
    connections' messages must be read and attributed to the topic."""
    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-5, 5, 10)] * 3, 1).astype(np.float32)
    raw = RB.serialize_pointcloud2(pts, 1.0)
    records = b""
    for conn in range(2):  # two connections, SAME topic
        hdr = RB._encode_fields({"op": bytes([RB.OP_CONNECTION]),
                                 "conn": struct.pack("<I", conn),
                                 "topic": "/radar"})
        data = RB._encode_fields({"topic": "/radar",
                                  "type": "sensor_msgs/PointCloud2",
                                  "md5sum": "*", "message_definition": ""})
        records += struct.pack("<I", len(hdr)) + hdr
        records += struct.pack("<I", len(data)) + data
    for conn in range(2):
        hdr = RB._encode_fields({"op": bytes([RB.OP_MSG]),
                                 "conn": struct.pack("<I", conn),
                                 "time": struct.pack("<II", 1, 0)})
        records += struct.pack("<I", len(hdr)) + hdr
        records += struct.pack("<I", len(raw)) + raw
    chunk_hdr = RB._encode_fields({"op": bytes([RB.OP_CHUNK]),
                                   "compression": "none",
                                   "size": struct.pack("<I", len(records))})
    bag_hdr = RB._encode_fields({"op": bytes([RB.OP_BAG]),
                                 "index_pos": struct.pack("<Q", 0),
                                 "conn_count": struct.pack("<I", 2),
                                 "chunk_count": struct.pack("<I", 1)})
    p = tmp_path / "multi.bag"
    with open(p, "wb") as f:
        f.write(RB._MAGIC)
        f.write(struct.pack("<I", len(bag_hdr)) + bag_hdr)
        f.write(struct.pack("<I", 0))            # empty bag-header data
        f.write(struct.pack("<I", len(chunk_hdr)) + chunk_hdr)
        f.write(struct.pack("<I", len(records)) + records)
    msgs = list(RB.read_messages(str(p)))
    assert len(msgs) == 2 and all(m.topic == "/radar" for m in msgs)


# ---------------------------------------------------------------------------
# CLI surface: one-line error, no traceback
# ---------------------------------------------------------------------------


def test_converter_cli_reports_cleanly(tmp_path, capsys):
    p = tmp_path / "cut.bag"
    bag = _write_minimal_bag(tmp_path / "full.bag")
    blob = open(bag, "rb").read()
    p.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(SystemExit) as e:
        RB.main([str(p), str(tmp_path / "out.npz")])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "Traceback" not in err
