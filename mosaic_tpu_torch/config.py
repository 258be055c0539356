"""Configuration of the port: the conf keys its join strategies and its
raster layer read.

Port copy of the part of ``mosaic_tpu.config`` that the planner, the
planned and refined PIP joins, the stream chunk, SpatialKNN's engine
choice, the raster checkpoint, the codecs' error policy, the chip store,
partition heat, the layout advisor and the CRS transforms read.  Keys
keep the JAX package's names, defaults, validators and error class, so a
setting carries over 1:1:

* ``mosaic.planner.enabled`` — the cost planner on or off;
* ``mosaic.planner.force.<op>`` — pin one operator's strategy (ops and
  strategies from ``sql.planner.FORCE_CHOICES``; "auto" clears the pin);
* ``mosaic.stream.chunk.rows`` — rows per streamed-join chunk, and the
  planner's monolithic-vs-streamed pivot;
* ``mosaic.knn.strategy`` — "auto", "brute", "ring" or a positive
  brute-right-max threshold;
* ``mosaic.join.refine.{enabled,depth,dup.threshold,max.cells,
  sample.rows}`` — the adaptive refined join;
* ``mosaic.raster.{checkpoint,use.checkpoint,tmp.prefix,blocksize}`` —
  the raster checkpoint directory and switch (``core/raster/checkpoint``),
  the temp prefix and the block size;
* ``mosaic.io.on.error`` — "raise", "skip" or "null", the codecs'
  policy for a malformed record (``resilience/ingest``);
* ``mosaic.crs.strict.datum`` — raise instead of warn where a CRS
  transform would apply an identity datum shift
  (``core/geometry/crs.py``);
* ``mosaic.shard.skew.refresh`` — every how many chunks the sharded
  streamed join re-packs its skew-aware placement
  (``parallel/placement.py``);
* ``mosaic.store.{dir,grid.res,shard.rows,mmap}`` — the chip store's
  default root ("" = none), the world-grid resolution new stores
  partition on, the rows per shard file and whether the reader
  memory-maps shards (``store/``);
* ``mosaic.heat.{halflife.ms,prior}`` — the half-life of the partition
  heat accumulators (0 = no decay) and whether the store-fed join primes
  its placement from that heat (``obs/heat.py``);
* ``mosaic.layout.{rows.per.cell,min.res,max.res}`` — the layout
  advisor's target rows per occupied cell and its resolution clamp
  (``sql/layout.py``).

The port knows no other key: ``apply_conf`` raises ``ConfigError`` for
any other one, and for the pins of ops it does not run (the
``equi_join`` and ``fusion`` ops).
"""

from __future__ import annotations

import dataclasses

MOSAIC_PLANNER_ENABLED = "mosaic.planner.enabled"
MOSAIC_PLANNER_FORCE_PREFIX = "mosaic.planner.force."
MOSAIC_STREAM_CHUNK_ROWS = "mosaic.stream.chunk.rows"
MOSAIC_KNN_STRATEGY = "mosaic.knn.strategy"
MOSAIC_JOIN_REFINE_ENABLED = "mosaic.join.refine.enabled"
MOSAIC_JOIN_REFINE_DEPTH = "mosaic.join.refine.depth"
MOSAIC_JOIN_REFINE_DUP_THRESHOLD = "mosaic.join.refine.dup.threshold"
MOSAIC_JOIN_REFINE_MAX_CELLS = "mosaic.join.refine.max.cells"
MOSAIC_JOIN_REFINE_SAMPLE_ROWS = "mosaic.join.refine.sample.rows"
MOSAIC_RASTER_CHECKPOINT = "mosaic.raster.checkpoint"
MOSAIC_RASTER_USE_CHECKPOINT = "mosaic.raster.use.checkpoint"
MOSAIC_RASTER_TMP_PREFIX = "mosaic.raster.tmp.prefix"
MOSAIC_RASTER_BLOCKSIZE = "mosaic.raster.blocksize"
MOSAIC_IO_ON_ERROR = "mosaic.io.on.error"
MOSAIC_CRS_STRICT_DATUM = "mosaic.crs.strict.datum"
MOSAIC_SHARD_SKEW_REFRESH = "mosaic.shard.skew.refresh"
MOSAIC_STORE_DIR = "mosaic.store.dir"
MOSAIC_STORE_GRID_RES = "mosaic.store.grid.res"
MOSAIC_STORE_SHARD_ROWS = "mosaic.store.shard.rows"
MOSAIC_STORE_MMAP = "mosaic.store.mmap"
MOSAIC_HEAT_HALFLIFE_MS = "mosaic.heat.halflife.ms"
MOSAIC_HEAT_PRIOR = "mosaic.heat.prior"
MOSAIC_LAYOUT_ROWS_PER_CELL = "mosaic.layout.rows.per.cell"
MOSAIC_LAYOUT_MIN_RES = "mosaic.layout.min.res"
MOSAIC_LAYOUT_MAX_RES = "mosaic.layout.max.res"

MOSAIC_RASTER_CHECKPOINT_DEFAULT = "/tmp/mosaic_tpu/checkpoint"
MOSAIC_RASTER_TMP_PREFIX_DEFAULT = "/tmp"
MOSAIC_RASTER_BLOCKSIZE_DEFAULT = 128


class ConfigError(ValueError):
    """A conf key carried an unusable value; the message names the key."""


@dataclasses.dataclass(frozen=True)
class MosaicConfig:
    """Immutable snapshot of the port's settings."""

    # cost planner (sql/planner.py): pure strategy choice, results are
    # the same either way
    planner_enabled: bool = True
    # ((op, strategy), ...) pins from mosaic.planner.force.<op> keys
    planner_force: tuple = ()
    # rows per streamed-join chunk; also the planner's monolithic pivot
    stream_chunk_rows: int = 262_144
    # "auto" | "brute" | "ring" | positive-int brute-right-max
    knn_strategy: str = "auto"
    # adaptive PIP refinement: the kill switch (beats any pin), levels
    # to deepen by, per-cell chip count below which a cell never
    # refines, cap on the refined set, leading rows the probe samples
    join_refine_enabled: bool = True
    join_refine_depth: int = 1
    join_refine_dup_threshold: int = 8
    join_refine_max_cells: int = 4_096
    join_refine_sample_rows: int = 65_536
    # raster checkpointing (core/raster/checkpoint.py): with the switch
    # on, serialized tiles spill GeoTIFF files into the directory
    raster_checkpoint: str = MOSAIC_RASTER_CHECKPOINT_DEFAULT
    raster_use_checkpoint: bool = False
    raster_tmp_prefix: str = MOSAIC_RASTER_TMP_PREFIX_DEFAULT
    raster_blocksize: int = MOSAIC_RASTER_BLOCKSIZE_DEFAULT
    # ingestion error policy (resilience/ingest.py): "raise" fails fast,
    # "skip" drops malformed records, "null" fills them
    io_on_error: str = "raise"
    # raise (instead of warn) when a CRS transform would apply an
    # identity datum shift: the EPSG registry has no Helmert parameters
    # for the code (core/geometry/crs.py)
    crs_strict_datum: bool = False
    # every K-th chunk of the sharded streamed join re-packs the
    # skew-aware placement (parallel/placement.py)
    shard_skew_refresh: int = 16
    # out-of-core chip store (store/): default root ("" = none), the
    # world-grid resolution, rows per shard file, mmap'd shard reads
    store_dir: str = ""
    store_grid_res: int = 1_024
    store_shard_rows: int = 4_194_304
    store_mmap: bool = True
    # partition heat (obs/heat.py): accumulator half-life (0 = never
    # decay) and the opt-in placement prior for the skew rebalancer
    heat_halflife_ms: float = 300_000.0
    heat_prior: bool = False
    # layout advisor (sql/layout.py): target rows per occupied cell and
    # the inclusive resolution clamp
    layout_rows_per_cell: int = 65_536
    layout_min_res: int = 64
    layout_max_res: int = 16_384


def _as_flag(key: str, value) -> bool:
    s = str(value).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ConfigError(f"{key}={value!r} is not a boolean "
                      "(use true/false)")


def _as_blocksize(key: str, value) -> int:
    try:
        n = int(str(value).strip())
    except (TypeError, ValueError):
        raise ConfigError(
            f"{key}={value!r} is not an integer") from None
    if n <= 0:
        raise ConfigError(f"{key}={n} must be a positive integer")
    return n


def _as_count(key: str, value) -> int:
    try:
        n = int(str(value).strip())
    except (TypeError, ValueError):
        raise ConfigError(
            f"{key}={value!r} is not an integer") from None
    if n < 0:
        raise ConfigError(f"{key}={n} must be >= 0 (0 disables)")
    return n


def _as_on_error(key: str, value) -> str:
    s = str(value).strip().lower()
    if s not in ("raise", "skip", "null"):
        raise ConfigError(f"{key}={value!r} invalid "
                          "(raise, skip, or null)")
    return s


def _as_millis(key: str, value) -> float:
    try:
        ms = float(str(value).strip())
    except (TypeError, ValueError):
        raise ConfigError(
            f"{key}={value!r} is not a number of milliseconds") from None
    if ms < 0:
        raise ConfigError(f"{key}={ms} must be >= 0 (0 disables)")
    return ms


def _as_str(key: str, value) -> str:
    return str(value)


def _as_knn_strategy(key: str, value) -> str:
    s = str(value).strip().lower()
    if s in ("auto", "brute", "ring"):
        return s
    try:
        n = int(s)
    except ValueError:
        raise ConfigError(
            f"{key}={value!r} invalid (auto, brute, ring, or a "
            "positive integer brute-right-max threshold)") from None
    if n <= 0:
        raise ConfigError(f"{key}={n} threshold must be positive")
    return str(n)


#: conf key -> (dataclass field, validating coercer)
_CONF_FIELDS = {
    MOSAIC_PLANNER_ENABLED: ("planner_enabled", _as_flag),
    MOSAIC_STREAM_CHUNK_ROWS: ("stream_chunk_rows", _as_blocksize),
    MOSAIC_KNN_STRATEGY: ("knn_strategy", _as_knn_strategy),
    MOSAIC_JOIN_REFINE_ENABLED: ("join_refine_enabled", _as_flag),
    MOSAIC_JOIN_REFINE_DEPTH: ("join_refine_depth", _as_blocksize),
    MOSAIC_JOIN_REFINE_DUP_THRESHOLD:
        ("join_refine_dup_threshold", _as_count),
    MOSAIC_JOIN_REFINE_MAX_CELLS:
        ("join_refine_max_cells", _as_blocksize),
    MOSAIC_JOIN_REFINE_SAMPLE_ROWS:
        ("join_refine_sample_rows", _as_blocksize),
    MOSAIC_RASTER_CHECKPOINT: ("raster_checkpoint", _as_str),
    MOSAIC_RASTER_USE_CHECKPOINT: ("raster_use_checkpoint", _as_flag),
    MOSAIC_RASTER_TMP_PREFIX: ("raster_tmp_prefix", _as_str),
    MOSAIC_RASTER_BLOCKSIZE: ("raster_blocksize", _as_blocksize),
    MOSAIC_IO_ON_ERROR: ("io_on_error", _as_on_error),
    MOSAIC_CRS_STRICT_DATUM: ("crs_strict_datum", _as_flag),
    MOSAIC_SHARD_SKEW_REFRESH: ("shard_skew_refresh", _as_blocksize),
    MOSAIC_STORE_DIR: ("store_dir", _as_str),
    MOSAIC_STORE_GRID_RES: ("store_grid_res", _as_blocksize),
    MOSAIC_STORE_SHARD_ROWS: ("store_shard_rows", _as_blocksize),
    MOSAIC_STORE_MMAP: ("store_mmap", _as_flag),
    MOSAIC_HEAT_HALFLIFE_MS: ("heat_halflife_ms", _as_millis),
    MOSAIC_HEAT_PRIOR: ("heat_prior", _as_flag),
    MOSAIC_LAYOUT_ROWS_PER_CELL: ("layout_rows_per_cell", _as_blocksize),
    MOSAIC_LAYOUT_MIN_RES: ("layout_min_res", _as_blocksize),
    MOSAIC_LAYOUT_MAX_RES: ("layout_max_res", _as_blocksize),
}


def _apply_planner_force(cfg: MosaicConfig, key: str,
                         value) -> MosaicConfig:
    """``mosaic.planner.force.<op>`` assignment: validate op and
    strategy against the planner's registry, "auto" clears the pin."""
    from .sql.planner import FORCE_CHOICES
    op = key[len(MOSAIC_PLANNER_FORCE_PREFIX):]
    if op not in FORCE_CHOICES:
        raise ConfigError(
            f"{key!r}: unknown plannable op {op!r} (known: "
            f"{', '.join(sorted(FORCE_CHOICES))})")
    s = str(value).strip().lower()
    if s not in FORCE_CHOICES[op]:
        raise ConfigError(
            f"{key}={value!r} invalid "
            f"({', '.join(FORCE_CHOICES[op])})")
    force = tuple((o, st) for o, st in cfg.planner_force if o != op)
    if s != "auto":
        force = force + ((op, s),)
    return dataclasses.replace(cfg, planner_force=force)


def planner_force_for(cfg: MosaicConfig, op: str) -> str:
    """The pinned strategy for ``op`` ("auto" when unpinned)."""
    for o, s in cfg.planner_force:
        if o == op:
            return s
    return "auto"


def apply_conf(cfg: MosaicConfig, key: str, value) -> MosaicConfig:
    """One validated conf assignment -> a new config; a key the port
    does not know raises ``ConfigError``."""
    if key.startswith(MOSAIC_PLANNER_FORCE_PREFIX):
        return _apply_planner_force(cfg, key, value)
    if key not in _CONF_FIELDS:
        raise ConfigError(
            f"unknown conf key {key!r} (known: "
            f"{', '.join(sorted(_CONF_FIELDS))} and "
            f"{MOSAIC_PLANNER_FORCE_PREFIX}<op>)")
    field, coerce = _CONF_FIELDS[key]
    return dataclasses.replace(cfg, **{field: coerce(key, value)})


_default_config: MosaicConfig = MosaicConfig()


def set_default_config(cfg: MosaicConfig) -> None:
    global _default_config
    _default_config = cfg


def default_config() -> MosaicConfig:
    return _default_config
