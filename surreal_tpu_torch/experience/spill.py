"""Disk spill tier, the port of ``surreal_tpu/experience/spill.py``: the
experience wire's rows doubled as a write-ahead log.

Shard servers append every ingested insert as a length-framed SEGMENT to
an append-only per-shard log file (``shard{i}.log``). The segment body is
a :class:`ColdCodec` encoding of ``PlaneSpec.pack``'s layout, so whatever
rides the wire rides the log, the lineage columns included: the log can
be replayed (``OffPolicyTrainer.replay_from_log``) and audited.

A log is a file that users keep, so its bytes are the reference's for the
same rows: the magic, the header struct, the JSON header with its key
order, the crc32 and the encoded body. A log written by either package is
read by the other's :class:`SpillLog`. bfloat16 columns are stored as
their 16-bit words (``PlaneSpec`` names them ``"<V2"``, as the
reference's ``ml_dtypes`` dtype prints), raw.

Cold encodings: the f32 reward-, discount- and value-like columns are
quantized to uint8 against the segment's observed ``[lo, hi]`` (the
segment header carries the range, so the dequantization is exact
arithmetic on recorded constants); the other f32 columns are stored as
float16; integer and bool columns are stored as they are. The error of a
quantized column is bounded by :func:`q8_error_bound`, half a
quantization step. ``quant=False`` writes the spec's bytes verbatim.

Durability (fault site ``experience.spill``): a torn tail (a truncated
segment, corrupt bytes, a crash mid-write) is skipped by the reader,
which resyncs on the next segment magic and counts the tear
(``tier/torn_segments``); a failing disk (ENOSPC) degrades the writer to
counting errors while the ring keeps serving, latched off after
``MAX_CONSECUTIVE_ERRORS`` failures in a row.

numpy and the standard library only: a process shard writes its log
without touching torch or the card.
"""

from __future__ import annotations

import errno
import glob
import heapq
import json
import os
import struct
import zlib
from typing import Any, Iterator, Mapping, Sequence

import numpy as np

from surreal_tpu_torch.experience import wire
from surreal_tpu_torch.utils import faults

# distinct from the wire's frame magic, so a log file can never be taken
# for (or concatenated into) wire traffic
WAL_MAGIC = b"\xa5XWL"
# after the magic: header_len, body_len, n_rows, crc32(body)
_SEG_HDR = struct.Struct("<IIII")

# per-field cold encodings
Q8 = "q8"      # uint8 quantization against the segment's [lo, hi]
F16 = "f16"    # float16 downcast
RAW = "raw"    # the spec dtype verbatim (non-float columns; quant=False logs)

DEFAULT_QUANT_FIELDS = ("reward", "discount", "value")


def q8_error_bound(lo: float, hi: float) -> float:
    """The reconstruction-error bound of one Q8 column: half a
    quantization step of the segment's range (255 steps span ``hi -
    lo``), plus one part in 2^10 of slack for the f32 scale arithmetic."""
    return (hi - lo) / 510.0 * (1.0 + 2.0 ** -10) + 1e-12


class ColdCodec:
    """Cold encoding of one :class:`wire.PlaneSpec` row layout, in the
    spec's canonical field order, as ``spec.pack``."""

    def __init__(
        self,
        spec: wire.PlaneSpec,
        quant: bool = True,
        quant_fields: Sequence[str] = DEFAULT_QUANT_FIELDS,
    ):
        self.spec = spec
        self.quant = bool(quant)
        qset = set(quant_fields)
        self.plan: list[tuple[str, tuple, np.dtype, str]] = []
        for name, shape, dtype in spec.fields:
            if self.quant and dtype == np.float32:
                # a full flattened name or its leaf ("reward" also selects
                # a nested ".../reward" column)
                enc = Q8 if name in qset or name.split("/")[-1] in qset else F16
            else:
                enc = RAW
            self.plan.append((name, shape, dtype, enc))
        self.cold_row_nbytes = sum(
            int(np.prod(s, dtype=np.int64)) * (1 if e == Q8 else 2 if e == F16 else d.itemsize)
            for _, s, d, e in self.plan
        )

    def encode(self, rows: Mapping[str, np.ndarray], n: int):
        """Rows [>=n, ...] per field -> (body bytes, qparams), where
        ``qparams`` maps each Q8 field to its segment ``[lo, hi]``."""
        parts: list[bytes] = []
        qparams: dict[str, list[float]] = {}
        for name, shape, dtype, enc in self.plan:
            arr = np.ascontiguousarray(rows[name][:n], dtype=dtype)
            if arr.shape != (n, *shape):
                raise ValueError(f"field {name!r}: got {arr.shape}, want {(n, *shape)}")
            if enc == Q8:
                flat = arr.astype(np.float32)
                lo = float(flat.min()) if n else 0.0
                hi = float(flat.max()) if n else 0.0
                scale = (hi - lo) or 1.0
                code = np.round((flat - lo) * (np.float32(255.0) / np.float32(scale))).astype(np.uint8)
                qparams[name] = [lo, hi]
                parts.append(code.tobytes())
            elif enc == F16:
                parts.append(arr.astype(np.float16).tobytes())
            else:
                parts.append(arr.tobytes())
        return b"".join(parts), qparams

    def decode(self, buf, n: int, qparams: Mapping[str, Sequence[float]] | None):
        """Inverse of :meth:`encode` -> {name: [n, ...]} in the spec's
        dtypes (Q8 and f16 columns reconstructed to float32)."""
        qparams = qparams or {}
        out: dict[str, np.ndarray] = {}
        off = 0
        for name, shape, dtype, enc in self.plan:
            count = n * int(np.prod(shape, dtype=np.int64))
            if enc == Q8:
                code = np.frombuffer(buf, np.uint8, count=count, offset=off)
                off += count
                lo, hi = qparams.get(name, (0.0, 0.0))
                step = np.float32((hi - lo) / 255.0)
                out[name] = (np.float32(lo) + code.astype(np.float32) * step).astype(dtype).reshape(n, *shape)
            elif enc == F16:
                out[name] = np.frombuffer(buf, np.float16, count=count, offset=off).astype(dtype).reshape(n, *shape)
                off += 2 * count
            else:
                out[name] = np.frombuffer(buf, dtype, count=count, offset=off).reshape(n, *shape).copy()
                off += count * dtype.itemsize
        return out


class SpillWriter:
    """Append-only per-shard segment log. A write failure is counted and
    degraded around (the ring is the availability tier; the spill tier may
    fall behind), never raised to the shard's serve loop."""

    # failed appends in a row before the writer latches off for the run:
    # a full disk must not cost a syscall storm per ingest
    MAX_CONSECUTIVE_ERRORS = 8

    def __init__(
        self,
        path: str,
        spec: wire.PlaneSpec,
        shard_id: int = 0,
        quant: bool = True,
        quant_fields: Sequence[str] = DEFAULT_QUANT_FIELDS,
        fsync: bool = False,
    ):
        self.path = str(path)
        self.shard_id = int(shard_id)
        self.codec = ColdCodec(spec, quant=quant, quant_fields=quant_fields)
        self.fsync = bool(fsync)
        self.seq = 0          # segment ordinal within this shard's log
        self.segments = 0
        self.rows = 0
        self.bytes = 0
        self.errors = 0
        self.failed = False   # latched after MAX_CONSECUTIVE_ERRORS
        self._streak = 0
        self._f = None

    def _file(self):
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "ab")
        return self._f

    def append(self, rows: Mapping[str, np.ndarray], n: int) -> None:
        if self.failed or n <= 0:
            return
        spill_fault = faults.fire("experience.spill")
        try:
            if spill_fault is not None and spill_fault["kind"] == "enospc":
                raise OSError(errno.ENOSPC, "chaos: enospc")
            body, qparams = self.codec.encode(rows, n)
            header = json.dumps({
                "seq": self.seq, "n": int(n), "shard": self.shard_id,
                "spec": self.codec.spec.to_json(),
                "quant": self.codec.quant, "q": qparams,
            }).encode()
            frame = (
                WAL_MAGIC
                + _SEG_HDR.pack(len(header), len(body), int(n), zlib.crc32(body) & 0xFFFFFFFF)
                + header + body
            )
            f = self._file()
            if spill_fault is not None and spill_fault["kind"] == "truncate_segment":
                # a crash mid-write: the segment's tail never lands. The
                # dead writer cannot know, so its books treat the segment
                # as unwritten; the READER counts the tear
                f.write(frame[: max(len(WAL_MAGIC) + 4, len(frame) // 2)])
                f.flush()
                self.seq += 1
                self.bytes += len(frame) // 2
                self._streak = 0
                return
            f.write(frame)
            f.flush()
            if self.fsync:
                if spill_fault is not None and spill_fault["kind"] == "delay_fsync":
                    faults.sleep_ms(spill_fault)
                os.fsync(f.fileno())
            self.seq += 1
            self.segments += 1
            self.rows += int(n)
            self.bytes += len(frame)
            self._streak = 0
        except OSError:
            self.errors += 1
            self._streak += 1
            if self._streak >= self.MAX_CONSECUTIVE_ERRORS:
                self.failed = True

    def stats(self) -> dict:
        return {
            "spill_segments": self.segments,
            "spill_rows": self.rows,
            "spill_bytes": self.bytes,
            "spill_errors": self.errors,
            "spill_failed": int(self.failed),
            "cold_bytes_per_row": float(self.codec.cold_row_nbytes),
        }

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None


class SpillReader:
    """One shard log -> its segments in append order, resyncing past torn
    tails: each parse failure (a short frame, a corrupt header, a crc
    mismatch) counts at least one ``torn_segments``, and the scan resumes
    at the next segment magic."""

    def __init__(self, path: str):
        self.path = str(path)
        self.torn_segments = 0

    def _parse(self, data: bytes, pos: int):
        """One segment at ``pos`` (a magic): (header, rows, n, end), or
        None on any tear."""
        hdr_at = pos + len(WAL_MAGIC)
        if hdr_at + _SEG_HDR.size > len(data):
            return None
        header_len, body_len, n, crc = _SEG_HDR.unpack_from(data, hdr_at)
        body_at = hdr_at + _SEG_HDR.size + header_len
        end = body_at + body_len
        if end > len(data):
            return None
        try:
            header = json.loads(data[hdr_at + _SEG_HDR.size: body_at].decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None
        body = data[body_at:end]
        if zlib.crc32(body) & 0xFFFFFFFF != crc:
            return None
        try:
            spec = wire.PlaneSpec.from_json(header["spec"])
            # the header's q keys ARE the writer's Q8 field set (encode
            # records a range for every quantized column), so custom
            # quant_fields round-trip without riding the header twice
            codec = ColdCodec(spec, quant=bool(header.get("quant", False)), quant_fields=tuple(header.get("q") or ()))
            rows = codec.decode(body, int(n), header.get("q"))
        except (KeyError, ValueError, TypeError):
            return None
        return header, rows, int(n), end

    def segments(self) -> Iterator[tuple[dict, dict, int]]:
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except OSError:
            return
        pos = 0
        while True:
            at = data.find(WAL_MAGIC, pos)
            if at < 0:
                break
            parsed = self._parse(data, at)
            if parsed is None:
                self.torn_segments += 1
                pos = at + 1  # resync forward on the next magic
                continue
            header, rows, n, end = parsed
            yield header, rows, n
            pos = end


class SpillLog:
    """A run's merged spill log: every ``shard*.log`` under a directory (or
    one explicit file), segments yielded in the global order ``(segment
    seq, shard id)``, whatever order the files are scanned in."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.paths = sorted(glob.glob(os.path.join(path, "shard*.log")))
        else:
            self.paths = [path]
        self.readers = [SpillReader(p) for p in self.paths]

    @property
    def torn_segments(self) -> int:
        return sum(r.torn_segments for r in self.readers)

    def segments(self) -> Iterator[tuple[dict, dict, int]]:
        def keyed(reader: SpillReader):
            for header, rows, n in reader.segments():
                yield (int(header.get("seq", 0)), int(header.get("shard", 0))), header, rows, n

        for _, header, rows, n in heapq.merge(*(keyed(r) for r in self.readers), key=lambda t: t[0]):
            yield header, rows, n


def build_writer(cfg: Mapping[str, Any] | None, spec: wire.PlaneSpec, shard_id: int) -> SpillWriter | None:
    """The shard's writer from the plane's ``spill`` sub-config
    (``replay.tiers.spill``: enabled, dir, quant, quant_fields, fsync);
    None when the tier is off."""
    if not cfg or not cfg.get("enabled") or not cfg.get("dir"):
        return None
    return SpillWriter(
        os.path.join(str(cfg["dir"]), f"shard{int(shard_id)}.log"),
        spec,
        shard_id=shard_id,
        quant=bool(cfg.get("quant", True)),
        quant_fields=tuple(cfg.get("quant_fields", DEFAULT_QUANT_FIELDS)),
        fsync=bool(cfg.get("fsync", False)),
    )
