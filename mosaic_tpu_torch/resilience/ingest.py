"""Degrade-not-die ingestion: structured decode errors + on_error policy.

Port copy of ``mosaic_tpu.resilience.ingest``, with its ``obs``
counters (``io/records_dropped``) and flight-recorder events
(``codec_error``, ``codec_record_dropped``).

Reference counterpart: the reference's OGR/GDAL readers inherit Spark's
per-record error semantics — ``spark.read...option("mode",
"PERMISSIVE")``-style handling where a malformed record becomes a null
row instead of a dead executor.  Our pure-Python codecs previously
leaked raw ``struct.error`` / ``zlib.error`` / ``IndexError`` from the
byte level, killing the whole batch on one truncated strip.

Two pieces:

* :func:`decode_guard` — wraps a low-level decode region so raw parser
  exceptions surface as :class:`CodecError` (a ``ValueError``) naming
  the file, feature, and byte offset.
* :class:`ErrorSink` — carries an ``on_error`` policy
  (``"raise" | "skip" | "null"``) through a codec.  ``raise`` (the
  default, from ``MosaicConfig.io_on_error``) preserves fail-fast
  behaviour; ``skip`` / ``null`` convert malformed records into
  :class:`ErrorRecord`\\ s and ``io/records_dropped`` metrics and keep
  decoding the intact remainder.
"""

from __future__ import annotations

import contextlib
import dataclasses
import struct
import zlib
from typing import List, Optional

from ..obs import metrics
from ..obs.recorder import recorder

__all__ = ["ErrorRecord", "CodecError", "ErrorSink", "decode_guard",
           "ON_ERROR_MODES"]

ON_ERROR_MODES = ("raise", "skip", "null")

#: raw exception types a decode region may leak from the byte level
_RAW_DECODE_ERRORS = (struct.error, zlib.error, IndexError, KeyError,
                      TypeError, UnicodeDecodeError, OverflowError,
                      ValueError)


@dataclasses.dataclass(frozen=True)
class ErrorRecord:
    """One malformed record, structured: where, what, why."""

    path: Optional[str]       # file path (None for in-memory bytes)
    feature: Optional[str]    # e.g. "strip 3", "message 1", "record 7"
    offset: Optional[int]     # byte offset where decoding failed
    reason: str               # first line of the underlying error
    error_type: str           # underlying exception class name


class CodecError(ValueError):
    """Decode failure with location context.

    A ``ValueError`` so existing ``pytest.raises(ValueError)`` /
    caller ``except ValueError`` contracts hold, but carrying the
    (path, feature, offset) triple as attributes and in the message.
    """

    def __init__(self, reason: str, path: Optional[str] = None,
                 feature: Optional[str] = None,
                 offset: Optional[int] = None):
        self.path = path
        self.feature = feature
        self.offset = offset
        self.reason = reason
        loc = []
        if path is not None:
            loc.append(str(path))
        if feature is not None:
            loc.append(str(feature))
        if offset is not None:
            loc.append(f"byte offset {offset}")
        prefix = " @ ".join(loc)
        super().__init__(f"{prefix}: {reason}" if prefix else reason)

    def record(self) -> ErrorRecord:
        return ErrorRecord(path=self.path, feature=self.feature,
                           offset=self.offset,
                           reason=self.reason.splitlines()[0][:200],
                           error_type=type(self).__name__)


@contextlib.contextmanager
def decode_guard(path: Optional[str] = None,
                 feature: Optional[str] = None,
                 offset: Optional[int] = None):
    """Turn raw byte-level parser exceptions into a located CodecError.

    Truncated buffers raise ``struct.error`` from ``struct.unpack``,
    ``zlib.error`` from ``decompress``, ``ValueError`` from
    ``np.frombuffer``, ``IndexError`` from short slices — all of them
    come out as ``CodecError("<file> @ <feature> @ byte offset N: …")``.
    An already-located CodecError passes through unchanged.
    """
    try:
        yield
    except CodecError:
        raise
    except _RAW_DECODE_ERRORS as e:
        err = CodecError(f"{type(e).__name__}: {e}", path=path,
                         feature=feature, offset=offset)
        # flight-recorder event regardless of on_error mode: a "raise"
        # that escapes to the excepthook dumps with the located error
        recorder.record("codec_error", path=path, feature=feature,
                        offset=offset,
                        reason=f"{type(e).__name__}: {e}"[:200])
        raise err from e


class ErrorSink:
    """Threads the ``on_error`` policy through one codec invocation."""

    def __init__(self, on_error: Optional[str] = None,
                 driver: str = "io", path: Optional[str] = None):
        if on_error is None:
            from .. import config as _config
            on_error = _config.default_config().io_on_error
        if on_error not in ON_ERROR_MODES:
            raise ValueError(
                f"on_error={on_error!r} invalid "
                f"(choose from {ON_ERROR_MODES})")
        self.on_error = on_error
        self.driver = driver
        self.path = path
        self.records: List[ErrorRecord] = []

    @property
    def raising(self) -> bool:
        return self.on_error == "raise"

    def handle(self, exc: BaseException,
               feature: Optional[str] = None,
               offset: Optional[int] = None) -> None:
        """Record a malformed record, or re-raise under ``"raise"``.

        After ``handle`` returns (skip/null modes) the caller drops or
        nulls the record and keeps going.
        """
        if self.on_error == "raise":
            raise exc
        if isinstance(exc, CodecError):
            rec = exc.record()
            if rec.path is None and self.path is not None:
                rec = dataclasses.replace(rec, path=self.path)
        else:
            rec = ErrorRecord(
                path=self.path, feature=feature, offset=offset,
                reason=f"{type(exc).__name__}: {exc}"[:200],
                error_type=type(exc).__name__)
        self.records.append(rec)
        recorder.record("codec_record_dropped", driver=self.driver,
                        path=rec.path, feature=rec.feature,
                        offset=rec.offset, reason=rec.reason,
                        error_type=rec.error_type)
        metrics.count("io/records_dropped")
        metrics.count(f"io/records_dropped/{self.driver}")

    def dropped(self) -> int:
        return len(self.records)

    def export(self, errors: Optional[list]) -> None:
        """Append this sink's records to a caller-supplied list."""
        if errors is not None:
            errors.extend(self.records)

    def meta_records(self) -> List[dict]:
        """Records as plain dicts (for ``tile.meta`` stamping)."""
        return [dataclasses.asdict(r) for r in self.records]
