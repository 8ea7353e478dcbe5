"""Minimal protobuf wire-format reader for the XSpace profiler format —
the port's own copy of ``raft_tpu/core/xplane.py``, the subset
:func:`raft_tpu_torch.core.profiling.parse_xplane` needs.

A capture directory can hold only an ``.xplane.pb`` protobuf (XLA's
profilers write one per host, ``plugins/profile/<run>/<host>.xplane.pb``)
and no chrome trace. This module decodes the XSpace containers straight
off the protobuf wire format with the standard library alone: no
``protobuf`` dependency, no generated classes, just varints and
length-delimited fields.

Decoded subset (field numbers from tensorflow/tsl's
``profiler/protobuf/xplane.proto``)::

    XSpace          planes=1
    XPlane          name=2 lines=3 event_metadata=4 stat_metadata=5
    XLine           name=2 timestamp_ns=3 events=4
    XEvent          metadata_id=1 offset_ps=2 duration_ps=3 stats=4
    XStat           metadata_id=1 double=2 uint64=3 int64=4 str=5
                    bytes=6 ref=7
    XEventMetadata  id=1 name=2 display_name=4
    XStatMetadata   id=1 name=2

Everything else on the wire (unknown fields, other stat kinds) is
skipped by wire type, which is what protobuf semantics ask of a partial
reader. Stats resolve through the plane's interning tables: a stat's
NAME always comes from ``stat_metadata[metadata_id]`` and a
``ref_value`` stat's VALUE is another ``stat_metadata`` entry's name.

The output is plain dicts (``parse_xspace``); conversion to
:class:`~raft_tpu_torch.core.profiling.DeviceOp` records lives in
``profiling.parse_xplane``, so this module stays a pure decoder with no
imports beyond the standard library.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple

# protobuf wire types
_VARINT, _FIXED64, _LENGTH, _FIXED32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """Decode one base-128 varint at ``pos``; returns (value, end)."""
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in xplane.pb")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint overflow in xplane.pb")


def fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Iterate a message's ``(field_number, wire_type, value)``
    triples: varints yield ints, length-delimited fields yield the
    raw ``bytes`` payload, fixed32/64 yield the raw 4/8 bytes.
    Unknown fields are the CALLER's business to skip — protobuf
    forward compatibility is "ignore what you don't know", not
    "fail on it"."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 0x7
        if wtype == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == _LENGTH:
            size, pos = _read_varint(buf, pos)
            if pos + size > len(buf):
                raise ValueError("truncated length-delimited field")
            val = buf[pos:pos + size]
            pos += size
        elif wtype == _FIXED64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == _FIXED32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _parse_stat(buf: bytes) -> dict:
    out = {"metadata_id": 0, "value": None}
    for fnum, wtype, val in fields(buf):
        if fnum == 1 and wtype == _VARINT:
            out["metadata_id"] = val
        elif fnum == 2 and wtype == _FIXED64:
            out["value"] = struct.unpack("<d", val)[0]
        elif fnum in (3, 4) and wtype == _VARINT:
            out["value"] = val
        elif fnum == 5 and wtype == _LENGTH:
            out["value"] = val.decode("utf-8", "replace")
        elif fnum == 6 and wtype == _LENGTH:
            out["value"] = val
        elif fnum == 7 and wtype == _VARINT:
            out["ref"] = val
    return out


def _parse_event(buf: bytes) -> dict:
    out = {"metadata_id": 0, "offset_ps": 0, "duration_ps": 0,
           "stats": []}
    for fnum, wtype, val in fields(buf):
        if fnum == 1 and wtype == _VARINT:
            out["metadata_id"] = val
        elif fnum == 2 and wtype == _VARINT:
            out["offset_ps"] = val
        elif fnum == 3 and wtype == _VARINT:
            out["duration_ps"] = val
        elif fnum == 4 and wtype == _LENGTH:
            out["stats"].append(_parse_stat(val))
    return out


def _parse_line(buf: bytes) -> dict:
    out = {"name": "", "timestamp_ns": 0, "events": []}
    for fnum, wtype, val in fields(buf):
        if fnum == 2 and wtype == _LENGTH:
            out["name"] = val.decode("utf-8", "replace")
        elif fnum == 3 and wtype == _VARINT:
            out["timestamp_ns"] = val
        elif fnum == 4 and wtype == _LENGTH:
            out["events"].append(_parse_event(val))
    return out


def _parse_named_metadata(buf: bytes) -> Tuple[int, str]:
    """XEventMetadata / XStatMetadata share the fields we need:
    ``id=1``, ``name=2``."""
    mid, name = 0, ""
    for fnum, wtype, val in fields(buf):
        if fnum == 1 and wtype == _VARINT:
            mid = val
        elif fnum == 2 and wtype == _LENGTH:
            name = val.decode("utf-8", "replace")
    return mid, name


def _parse_map_entry(buf: bytes) -> Tuple[int, bytes]:
    """A protobuf map entry is a nested message ``{key=1, value=2}``;
    XPlane's metadata maps key by int64 id."""
    key, value = 0, b""
    for fnum, wtype, val in fields(buf):
        if fnum == 1 and wtype == _VARINT:
            key = val
        elif fnum == 2 and wtype == _LENGTH:
            value = val
    return key, value


def _parse_plane(buf: bytes) -> dict:
    out = {"name": "", "lines": [],
           "event_metadata": {}, "stat_metadata": {}}
    for fnum, wtype, val in fields(buf):
        if fnum == 2 and wtype == _LENGTH:
            out["name"] = val.decode("utf-8", "replace")
        elif fnum == 3 and wtype == _LENGTH:
            out["lines"].append(_parse_line(val))
        elif fnum == 4 and wtype == _LENGTH:
            key, sub = _parse_map_entry(val)
            mid, name = _parse_named_metadata(sub)
            out["event_metadata"][mid or key] = name
        elif fnum == 5 and wtype == _LENGTH:
            key, sub = _parse_map_entry(val)
            mid, name = _parse_named_metadata(sub)
            out["stat_metadata"][mid or key] = name
    return out


def parse_xspace(data: bytes) -> dict:
    """Decode one serialized XSpace into ``{"planes": [plane-dict]}``
    (see module docstring for the per-plane shape). Pure function of
    the bytes — the committed fixture pins it."""
    planes: List[dict] = []
    for fnum, wtype, val in fields(data):
        if fnum == 1 and wtype == _LENGTH:
            planes.append(_parse_plane(val))
    return {"planes": planes}


def resolve_stats(event: dict, stat_metadata: Dict[int, str]) -> dict:
    """``{stat_name: value}`` for one event, names resolved through
    the plane's ``stat_metadata`` interning table; a ``ref`` stat's
    value is ANOTHER table entry's name (interned string)."""
    out = {}
    for stat in event["stats"]:
        name = stat_metadata.get(stat["metadata_id"])
        if not name:
            continue
        if "ref" in stat:
            out[name] = stat_metadata.get(stat["ref"], "")
        elif stat["value"] is not None:
            out[name] = stat["value"]
    return out
