"""Reading and writing ``.dkt`` trace files.

``TraceWriter`` is append-only: declare streams, append one chunk per
``SampleBlock``, close to seal the footer (index + tag table + user meta).
``TraceReader`` memory-maps the file, parses the footer, and serves
O(log chunks) time seeks plus zero-copy columnar reads — a multi-gigabyte
recording can be scanned chunk by chunk without materializing it.

    with TraceWriter(path, meta={"run": "smoke"}) as w:
        sid = w.add_stream("az5-a890m-0/chip0", node="az5-a890m-0", sps=1000)
        w.append(sid, block)

    with TraceReader(path) as r:
        block = r.read(sid)                      # whole stream, one block
        tail = r.read(sid, t0=1.0)               # seek: chunks past t=1 s
        for b in r.blocks(sid):                  # streaming, chunk by chunk
            ...
"""
from __future__ import annotations

import mmap
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.telemetry.samples import SampleBlock
from repro_torch.tracestore import format as fmt


class TraceWriter:
    """Append-only ``.dkt`` writer; one chunk per appended block."""

    def __init__(self, path, meta: Optional[Dict] = None):
        self.path = os.fspath(path)
        self.meta: Dict = dict(meta or {})
        self._f = open(self.path, "wb")
        self._f.write(fmt.encode_header())
        self._offset = fmt.HEADER.size
        self._streams: List[Dict] = []
        self._tags: List[str] = []
        self._tag_ids: Dict[str, int] = {}
        self._chunks: List[fmt.ChunkInfo] = []
        self._closed = False

    def _intern_tag(self, name: str) -> int:
        tid = self._tag_ids.get(name)
        if tid is None:
            tid = self._tag_ids[name] = len(self._tags)
            self._tags.append(name)
        return tid

    def add_stream(self, name: str, **attrs) -> int:
        """Declare a stream (one probe's sample timeline); returns its id.
        ``attrs`` (node, device, sps, volts, ...) land in the footer."""
        sid = len(self._streams)
        self._streams.append({"id": sid, "name": name, **attrs})
        return sid

    @property
    def n_streams(self) -> int:
        return len(self._streams)

    @property
    def n_chunks(self) -> int:
        return len(self._chunks)

    def append(self, stream_id: int, block: SampleBlock) -> fmt.ChunkInfo:
        """Append one block as a chunk (empty blocks round-trip too: a
        window that produced no reports is still a window on replay)."""
        if self._closed:
            raise RuntimeError("TraceWriter is closed")
        if not 0 <= stream_id < len(self._streams):
            raise ValueError(f"unknown stream id {stream_id}")
        payload = fmt.encode_chunk(stream_id, block, self._intern_tag)
        info = fmt.chunk_info(stream_id, self._offset, len(payload), block)
        self._f.write(payload)
        self._offset += len(payload)
        self._chunks.append(info)
        return info

    def close(self) -> str:
        """Seal the file (footer + trailer); idempotent."""
        if not self._closed:
            self._f.write(fmt.encode_footer(self._streams, self._tags,
                                            self._chunks, self.meta))
            self._f.close()
            self._closed = True
        return self.path

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc):
        self.close()


class TraceReader:
    """mmap-backed ``.dkt`` reader with per-stream chunk indexes."""

    def __init__(self, path, use_mmap: bool = True):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        if use_mmap and os.fstat(self._f.fileno()).st_size > 0:
            self._buf = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        else:
            self._buf = self._f.read()
        self.version = fmt.decode_header(self._buf[:fmt.HEADER.size])
        doc = fmt.decode_footer(self._buf)
        self.streams: List[Dict] = doc["streams"]
        self.tags: List[str] = doc["tags"]
        self.meta: Dict = doc.get("meta", {})
        self._chunks: Dict[int, List[fmt.ChunkInfo]] = {
            s["id"]: [] for s in self.streams}
        for row in doc["chunks"]:
            info = fmt.ChunkInfo.from_row(row)
            self._chunks.setdefault(info.stream_id, []).append(info)
        # per-stream end-timestamp key for O(log chunks) time seeks; the
        # running maximum keeps the key sorted even though empty chunks
        # record t0=t1=0.0 (an empty window between non-empty ones must not
        # break the binary search)
        self._t1s: Dict[int, np.ndarray] = {
            sid: (np.maximum.accumulate(np.array([c.t1 for c in chunks]))
                  if chunks else np.zeros(0))
            for sid, chunks in self._chunks.items()}

    # -- inventory -----------------------------------------------------------

    def stream_ids(self) -> List[int]:
        return [s["id"] for s in self.streams]

    def stream(self, stream_id: int) -> Dict:
        for s in self.streams:
            if s["id"] == stream_id:
                return s
        raise KeyError(f"no stream {stream_id} in {self.path}")

    def chunks(self, stream_id: int) -> List[fmt.ChunkInfo]:
        return list(self._chunks.get(stream_id, []))

    def n_samples(self, stream_id: Optional[int] = None) -> int:
        if stream_id is not None:
            return sum(c.n for c in self._chunks.get(stream_id, []))
        return sum(c.n for cs in self._chunks.values() for c in cs)

    def time_range(self, stream_id: int) -> tuple:
        """(t_first, t_last) over the stream's non-empty chunks."""
        ne = [c for c in self._chunks.get(stream_id, []) if c.n]
        if not ne:
            return (0.0, 0.0)
        return (ne[0].t0, ne[-1].t1)

    # -- reads ---------------------------------------------------------------

    def read_chunk(self, info: fmt.ChunkInfo) -> SampleBlock:
        sid, block, end = fmt.decode_chunk(self._buf, info.offset, self.tags)
        if sid != info.stream_id or end != info.offset + info.nbytes:
            raise fmt.TraceFormatError(
                f"chunk at {info.offset} disagrees with the footer index")
        return block

    def blocks(self, stream_id: int) -> Iterator[SampleBlock]:
        """Stream a stream's chunks in append order (window boundaries
        preserved — replay re-drives sessions window by window)."""
        for info in self._chunks.get(stream_id, []):
            yield self.read_chunk(info)

    def seek(self, stream_id: int, t: float) -> int:
        """Index of the first chunk whose span ends at or after ``t``
        (``len(chunks)`` when the whole stream is earlier). Footer-index
        binary search only; no payload bytes are touched."""
        return int(np.searchsorted(self._t1s.get(stream_id, np.zeros(0)), t,
                                   side="left"))

    def read(self, stream_id: int, t0: Optional[float] = None,
             t1: Optional[float] = None) -> SampleBlock:
        """One concatenated block for ``[t0, t1]`` (whole stream when
        unbounded), trimmed to the samples inside the span."""
        chunks = self._chunks.get(stream_id, [])
        lo = self.seek(stream_id, t0) if t0 is not None else 0
        picked = []
        for info in chunks[lo:]:
            if t1 is not None and info.n and info.t0 > t1:
                break
            picked.append(self.read_chunk(info))
        block = SampleBlock.concat(picked)
        if block.n and (t0 is not None or t1 is not None):
            lo_i = int(np.searchsorted(block.t, t0, "left")) if t0 is not None else 0
            hi_i = int(np.searchsorted(block.t, t1, "right")) if t1 is not None else block.n
            block = slice_block(block, lo_i, hi_i)
        return block

    def close(self):
        if isinstance(self._buf, mmap.mmap):
            try:
                self._buf.close()
            except BufferError:
                pass    # decoded blocks still view the map; the mapping is
                        # released when the last view is collected
        self._f.close()

    def __enter__(self) -> "TraceReader":
        return self

    def __exit__(self, *exc):
        self.close()


def slice_block(block: SampleBlock, lo: int, hi: int) -> SampleBlock:
    """Sample-range slice preserving the segment structure."""
    lo = max(0, min(lo, block.n))
    hi = max(lo, min(hi, block.n))
    if lo == 0 and hi == block.n:
        return block
    bounds, maps = [0], []
    for k, m in enumerate(block.seg_maps):
        s = max(int(block.seg_bounds[k]), lo)
        e = min(int(block.seg_bounds[k + 1]), hi)
        if e > s:
            bounds.append(e - lo)
            maps.append(m)
    if len(bounds) == 1:
        bounds = [0] if hi == lo else [0, hi - lo]
        maps = [{}] if hi > lo else []
    return SampleBlock(t=block.t[lo:hi], volts=block.volts[lo:hi],
                       watts=block.watts[lo:hi], dt=block.dt[lo:hi],
                       bits=block.bits[lo:hi],
                       seg_bounds=np.asarray(bounds, np.int64),
                       seg_maps=tuple(maps), n_avg=block.n_avg)
