"""The ``.dkt`` binary trace format (DALEK trace, version 1).

A trace file persists the telemetry platform's columnar ``SampleBlock``
streams bit-exactly, so a recorded run can be reloaded and replayed
offline with the same energy numbers the live session produced.

File layout (all integers little-endian)::

    header   := b"DKTR" u32:version
    chunk*   := chunk_header chunk_payload          (append-only)
    footer   := json (streams, tags, chunk index, user meta)
    trailer  := u64:footer_nbytes b"DKTE"

One chunk holds one ``SampleBlock`` — recorders append one chunk per
sampling window, so window boundaries survive the round trip (replay needs
them to re-drive sessions window by window). Chunk payloads are raw numpy
columns::

    chunk_header  := u32:stream_id u32:n_segs u64:n u64:n_map u32:n_avg
    chunk_payload := f64 t[n] | f64 volts[n] | f64 watts[n] | f64 dt[n]
                     u8 bits[n] | i64 seg_bounds[n_segs+1]
                     u32 seg_entry_counts[n_segs]
                     u8 entry_lines[n_map] | u32 entry_tag_ids[n_map]

Tag names are interned once per file in the footer's ``tags`` table;
segment maps store (gpio line, tag id) pairs, so recycled GPIO channels
(any number of distinct names over a run) cost 5 bytes per mapping entry
instead of a string copy per segment. The footer's chunk index rows
``[stream_id, offset, nbytes, n, t0, t1]`` give O(log chunks) time seeks
without touching the payload bytes, and decoding builds numpy views
directly over the file buffer (mmap-friendly: nothing is copied until a
reduction runs).
"""
from __future__ import annotations

import dataclasses
import json
import struct
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np

from repro_torch.telemetry.samples import SampleBlock

MAGIC = b"DKTR"
END_MAGIC = b"DKTE"
VERSION = 1

HEADER = struct.Struct("<4sI")            # magic, version
CHUNK_HDR = struct.Struct("<IIQQI")       # stream_id, n_segs, n, n_map, n_avg
TRAILER = struct.Struct("<Q4s")           # footer_nbytes, end magic


class TraceFormatError(ValueError):
    """The bytes are not a readable ``.dkt`` trace (bad magic, truncated
    file, or an unsupported version)."""


def encode_header() -> bytes:
    return HEADER.pack(MAGIC, VERSION)


def decode_header(buf: bytes) -> int:
    """Validate the leading magic and return the format version."""
    if len(buf) < HEADER.size:
        raise TraceFormatError(f"file too short for a .dkt header "
                               f"({len(buf)} bytes)")
    magic, version = HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise TraceFormatError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if version != VERSION:
        raise TraceFormatError(f"unsupported .dkt version {version} "
                               f"(this reader speaks {VERSION})")
    return version


@dataclasses.dataclass(frozen=True)
class ChunkInfo:
    """One chunk-index row from the footer."""

    stream_id: int
    offset: int
    nbytes: int
    n: int
    t0: float            # first report timestamp (0.0 when empty)
    t1: float            # last report timestamp (0.0 when empty)

    def row(self) -> list:
        return [self.stream_id, self.offset, self.nbytes, self.n,
                self.t0, self.t1]

    @classmethod
    def from_row(cls, row) -> "ChunkInfo":
        return cls(int(row[0]), int(row[1]), int(row[2]), int(row[3]),
                   float(row[4]), float(row[5]))


def encode_chunk(stream_id: int, block: SampleBlock,
                 intern_tag: Callable[[str], int]) -> bytes:
    """Serialize one ``SampleBlock`` as a chunk. ``intern_tag`` maps a tag
    name to its id in the file's tag table (appending on first use)."""
    n = block.n
    n_segs = len(block.seg_maps)
    lines: List[int] = []
    ids: List[int] = []
    counts = np.zeros(n_segs, "<u4")
    for k, m in enumerate(block.seg_maps):
        counts[k] = len(m)
        for line, name in m.items():
            lines.append(line)
            ids.append(intern_tag(name))
    n_map = len(lines)
    parts = [
        CHUNK_HDR.pack(stream_id, n_segs, n, n_map, block.n_avg),
        np.ascontiguousarray(block.t, "<f8").tobytes(),
        np.ascontiguousarray(block.volts, "<f8").tobytes(),
        np.ascontiguousarray(block.watts, "<f8").tobytes(),
        np.ascontiguousarray(block.dt, "<f8").tobytes(),
        np.ascontiguousarray(block.bits, "u1").tobytes(),
        np.ascontiguousarray(block.seg_bounds, "<i8").tobytes(),
        counts.tobytes(),
        np.asarray(lines, "u1").tobytes(),
        np.asarray(ids, "<u4").tobytes(),
    ]
    return b"".join(parts)


def decode_chunk(buf, offset: int,
                 tags: List[str]) -> Tuple[int, SampleBlock, int]:
    """Decode the chunk at ``offset``; returns (stream_id, block, end).

    Columns are numpy views over ``buf`` (zero-copy when ``buf`` is a
    mmap), so streaming a large trace only faults the pages a reduction
    actually touches.
    """
    try:
        stream_id, n_segs, n, n_map, n_avg = CHUNK_HDR.unpack_from(buf, offset)
    except struct.error as e:
        raise TraceFormatError(f"truncated chunk header at {offset}") from e
    off = offset + CHUNK_HDR.size

    def take(dtype, count):
        nonlocal off
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=off)
        off += arr.nbytes
        return arr

    t = take("<f8", n)
    volts = take("<f8", n)
    watts = take("<f8", n)
    dt = take("<f8", n)
    bits = take("u1", n)
    seg_bounds = take("<i8", n_segs + 1)    # always n_segs+1 (1 when empty)
    counts = take("<u4", n_segs)
    lines = take("u1", n_map)
    ids = take("<u4", n_map)
    maps: List[Mapping[int, str]] = []
    pos = 0
    for k in range(n_segs):
        c = int(counts[k])
        maps.append({int(lines[pos + j]): tags[int(ids[pos + j])]
                     for j in range(c)})
        pos += c
    block = SampleBlock(t=t, volts=volts, watts=watts, dt=dt, bits=bits,
                        seg_bounds=np.asarray(seg_bounds, np.int64),
                        seg_maps=tuple(maps), n_avg=int(n_avg))
    return stream_id, block, off


def chunk_info(stream_id: int, offset: int, nbytes: int,
               block: SampleBlock) -> ChunkInfo:
    return ChunkInfo(stream_id, offset, nbytes, block.n,
                     float(block.t[0]) if block.n else 0.0,
                     float(block.t[-1]) if block.n else 0.0)


def encode_footer(streams: List[Dict], tags: List[str],
                  chunks: List[ChunkInfo], meta: Dict) -> bytes:
    doc = {"version": VERSION, "streams": streams, "tags": tags,
           "chunks": [c.row() for c in chunks], "meta": meta}
    payload = json.dumps(doc).encode("utf-8")
    return payload + TRAILER.pack(len(payload), END_MAGIC)


def decode_footer(buf) -> Dict:
    """Parse the footer from the tail of a full file buffer."""
    if len(buf) < HEADER.size + TRAILER.size:
        raise TraceFormatError("file too short for a .dkt trailer")
    nbytes, end = TRAILER.unpack_from(buf, len(buf) - TRAILER.size)
    if end != END_MAGIC:
        raise TraceFormatError(
            f"bad end magic {end!r} — file truncated or not closed")
    start = len(buf) - TRAILER.size - nbytes
    if start < HEADER.size:
        raise TraceFormatError("footer length exceeds file size")
    doc = json.loads(bytes(buf[start:start + nbytes]).decode("utf-8"))
    if doc.get("version") != VERSION:
        raise TraceFormatError(f"unsupported footer version "
                               f"{doc.get('version')}")
    return doc
