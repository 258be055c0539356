"""Configuration of the port: the conf keys its join strategies and its
raster layer read.

Port copy of the part of ``mosaic_tpu.config`` that the function
surface (``functions/context.py``), the planner, the planned and refined
PIP joins, the stream chunk, SpatialKNN's engine
choice, the raster checkpoint, the codecs' error policy, the chip store,
partition heat, the layout advisor and the CRS transforms read.  Keys
keep the JAX package's names, defaults, validators and error class, so a
setting carries over 1:1:

* ``mosaic.index.system``, ``mosaic.geometry.api`` — the grid and the
  geometry backend ``enable_mosaic()`` binds when its caller names
  none (``geometry_api`` keeps the reference's value "JAX": it names
  the backend a conf was written for, and the port's geometry runs on
  torch whatever it says);
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
  (``sql/layout.py``);
* ``mosaic.trace.enabled``, ``mosaic.metrics.enabled`` — turn the span
  tracer (and with it the metrics registry) or the registry alone on
  when the config is set (``obs/``; they never turn an instrument off);
* ``mosaic.obs.dump.cooldown.ms`` — the spacing of automatic
  flight-recorder dumps (``obs/recorder.py``);
* ``mosaic.obs.sample.ms``, ``mosaic.obs.slo.dump`` — the telemetry
  sampler's cadence (0 = no thread; env ``MOSAIC_TPU_OBS_SAMPLE_MS``
  pins it) and a dump at each SLO breach (``obs/timeseries.py``,
  ``obs/slo.py``);
* ``mosaic.obs.profile.hz``, ``mosaic.obs.profile.trace.ms`` — the
  sampling host profiler's rate (0 = off; env ``MOSAIC_TPU_PROFILE_HZ``
  pins it) and the device trace a triggered dump takes
  (``obs/profiler.py``);
* ``mosaic.mem.budget.bytes``, ``mosaic.mem.pressure.high``,
  ``mosaic.obs.mem.enabled`` — the live device-memory budget (0 =
  unlimited), the pressure past which the streamed executor halves its
  next chunk, and the memory ledger's switch (``obs/memwatch.py``);
* ``mosaic.principal``, ``mosaic.query.deadline.ms``,
  ``mosaic.audit.{path,rotate.bytes,retain}`` — the query accounting
  plane (``obs/accounting.py``);
* ``mosaic.obs.fleet.{dir,window.ms,events}`` — the telemetry spool
  the sampler writes (``obs/spool.py``); ``mosaic.obs.fleet.stale.ms``
  — the spool age past which the aggregator flags a worker stale
  (``obs/fleet.py``);
* ``mosaic.history.{dir,segment.bytes,segment.age.ms,retain,window.ms}``
  — the workload history store (``obs/history.py``): its directory (""
  = off), the open segment's size and age bounds, the closed segments
  kept and the compaction window;
* ``mosaic.planner.stats.path`` — the planner's learned-coefficient
  file ("" = in process only; env ``MOSAIC_TPU_PLANNER_STATS`` wins),
  the same JSON as the JAX package's, so either package loads the
  other's (``sql/planner.py``);
* ``mosaic.obs.slow.query.ms`` — an SQL query slower than this dumps
  the flight recorder (0 = never; ``sql/engine.py``);
* ``mosaic.fusion.{enabled,max.ops}`` — whole-query fusion on or off
  and its group-size cap (``perf/fusion.py``);
* ``mosaic.serve.{port,workers,queue.depth,quota.concurrency,quota.qps,
  deadline.ms,drain.ms}`` — the query server's listen port (0 =
  ephemeral), worker threads, admission-queue depth, per-principal
  quotas (0 disables either), default request deadline (0 = none) and
  drain grace (``serve/server.py``, ``serve/admission.py``);
* ``mosaic.serve.batch.{window.ms,max,rows.max}`` — the micro-batcher's
  wait for more compatible point lookups, the most queries one batch
  coalesces (0 = no batching) and the largest table still batchable
  (``serve/batching.py``, ``sql/engine.classify_batchable``);
* ``mosaic.serve.fleet.{workers,dir,restart.max,restart.window.ms,
  health.ms,reap.ms}``, ``mosaic.serve.scoreboard.slots`` — the serving
  fleet's worker processes, its runtime directory ("" = a fresh temp
  dir), the crash-loop breaker, the health tick (0 = no thread), the
  dead-claim reap interval and the shared scoreboard's slot count
  (``serve/supervisor.py``, ``serve/scoreboard.py``);

* ``mosaic.device.dtype``, ``mosaic.exact.fallback`` — the precision
  policy's fields ("float32" or "float64"; a flag), accepted and
  validated as the JAX package does, and read by nothing in either
  package;
* ``mosaic.jit.cache.dir`` — the persistent kernel cache: the directory
  the hand kernels are built into and loaded from ("" = the package's
  ``_build/``; env ``MOSAIC_TPU_JIT_CACHE_DIR`` wins), wired by
  ``set_default_config`` through ``perf.jit_cache.configure_persistent_cache``.

A successful ``apply_conf`` records a ``config`` flight-recorder event.
``apply_conf`` raises ``ConfigError`` for any key the port does not know;
``MosaicConfig.from_confs`` takes Spark's open namespace and skips them.
"""

from __future__ import annotations

import dataclasses

MOSAIC_INDEX_SYSTEM = "mosaic.index.system"
MOSAIC_GEOMETRY_API = "mosaic.geometry.api"
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
MOSAIC_DEVICE_DTYPE = "mosaic.device.dtype"
MOSAIC_EXACT_FALLBACK = "mosaic.exact.fallback"
MOSAIC_JIT_CACHE_DIR = "mosaic.jit.cache.dir"
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
MOSAIC_TRACE_ENABLED = "mosaic.trace.enabled"
MOSAIC_METRICS_ENABLED = "mosaic.metrics.enabled"
MOSAIC_OBS_DUMP_COOLDOWN_MS = "mosaic.obs.dump.cooldown.ms"
MOSAIC_OBS_SAMPLE_MS = "mosaic.obs.sample.ms"
MOSAIC_OBS_SLO_DUMP = "mosaic.obs.slo.dump"
MOSAIC_OBS_PROFILE_HZ = "mosaic.obs.profile.hz"
MOSAIC_OBS_PROFILE_TRACE_MS = "mosaic.obs.profile.trace.ms"
MOSAIC_PRINCIPAL = "mosaic.principal"
MOSAIC_QUERY_DEADLINE_MS = "mosaic.query.deadline.ms"
MOSAIC_AUDIT_PATH = "mosaic.audit.path"
MOSAIC_AUDIT_ROTATE_BYTES = "mosaic.audit.rotate.bytes"
MOSAIC_AUDIT_RETAIN = "mosaic.audit.retain"
MOSAIC_MEM_BUDGET_BYTES = "mosaic.mem.budget.bytes"
MOSAIC_MEM_PRESSURE_HIGH = "mosaic.mem.pressure.high"
MOSAIC_OBS_MEM_ENABLED = "mosaic.obs.mem.enabled"
MOSAIC_OBS_FLEET_DIR = "mosaic.obs.fleet.dir"
MOSAIC_OBS_FLEET_STALE_MS = "mosaic.obs.fleet.stale.ms"
MOSAIC_OBS_FLEET_WINDOW_MS = "mosaic.obs.fleet.window.ms"
MOSAIC_OBS_FLEET_EVENTS = "mosaic.obs.fleet.events"
MOSAIC_PLANNER_STATS_PATH = "mosaic.planner.stats.path"
MOSAIC_OBS_SLOW_QUERY_MS = "mosaic.obs.slow.query.ms"
MOSAIC_FUSION_ENABLED = "mosaic.fusion.enabled"
MOSAIC_FUSION_MAX_OPS = "mosaic.fusion.max.ops"
MOSAIC_HISTORY_DIR = "mosaic.history.dir"
MOSAIC_HISTORY_SEGMENT_BYTES = "mosaic.history.segment.bytes"
MOSAIC_HISTORY_SEGMENT_AGE_MS = "mosaic.history.segment.age.ms"
MOSAIC_HISTORY_RETAIN = "mosaic.history.retain"
MOSAIC_HISTORY_WINDOW_MS = "mosaic.history.window.ms"
MOSAIC_SERVE_PORT = "mosaic.serve.port"
MOSAIC_SERVE_WORKERS = "mosaic.serve.workers"
MOSAIC_SERVE_QUEUE_DEPTH = "mosaic.serve.queue.depth"
MOSAIC_SERVE_QUOTA_CONCURRENCY = "mosaic.serve.quota.concurrency"
MOSAIC_SERVE_QUOTA_QPS = "mosaic.serve.quota.qps"
MOSAIC_SERVE_DEADLINE_MS = "mosaic.serve.deadline.ms"
MOSAIC_SERVE_DRAIN_MS = "mosaic.serve.drain.ms"
MOSAIC_SERVE_BATCH_WINDOW_MS = "mosaic.serve.batch.window.ms"
MOSAIC_SERVE_BATCH_MAX = "mosaic.serve.batch.max"
MOSAIC_SERVE_BATCH_ROWS_MAX = "mosaic.serve.batch.rows.max"
MOSAIC_SERVE_FLEET_WORKERS = "mosaic.serve.fleet.workers"
MOSAIC_SERVE_FLEET_DIR = "mosaic.serve.fleet.dir"
MOSAIC_SERVE_FLEET_RESTART_MAX = "mosaic.serve.fleet.restart.max"
MOSAIC_SERVE_FLEET_RESTART_WINDOW_MS = \
    "mosaic.serve.fleet.restart.window.ms"
MOSAIC_SERVE_FLEET_HEALTH_MS = "mosaic.serve.fleet.health.ms"
MOSAIC_SERVE_FLEET_REAP_MS = "mosaic.serve.fleet.reap.ms"
MOSAIC_SERVE_SCOREBOARD_SLOTS = "mosaic.serve.scoreboard.slots"

MOSAIC_RASTER_CHECKPOINT_DEFAULT = "/tmp/mosaic_tpu/checkpoint"
MOSAIC_RASTER_TMP_PREFIX_DEFAULT = "/tmp"
MOSAIC_RASTER_BLOCKSIZE_DEFAULT = 128


class ConfigError(ValueError):
    """A conf key carried an unusable value; the message names the key."""


@dataclasses.dataclass(frozen=True)
class MosaicConfig:
    """Immutable snapshot of the port's settings."""

    # the (index system, geometry backend) pair a MosaicContext binds;
    # enable_mosaic() reads them when its caller names none
    index_system: str = "H3"          # "H3" | "BNG" | "CUSTOM(...)"
    geometry_api: str = "JAX"         # the reference's backend name
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
    # precision policy (the JAX package's f32 cell assignment with an f64
    # recheck band): validated, read by nothing in either package
    device_dtype: str = "float32"
    exact_fallback: bool = True
    # persistent kernel cache: the directory the hand kernels are built
    # into and loaded from ("" = _build/; env MOSAIC_TPU_JIT_CACHE_DIR
    # takes precedence), wired by set_default_config
    jit_cache_dir: str = ""
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
    # observability switches (obs/): the span tracer and the metrics
    # registry; env vars MOSAIC_TPU_TRACE / MOSAIC_TPU_METRICS turn them
    # on too, and conf keys only ever turn instruments on
    trace_enabled: bool = False
    metrics_enabled: bool = False
    # minimum spacing of automatic dump bundles (0 disables the gate)
    obs_dump_cooldown_ms: float = 30_000.0
    # telemetry sampler cadence (ms; 0 = no sampler thread) and a dump
    # bundle at every SLO breach transition
    obs_sample_ms: float = 0.0
    obs_slo_dump: bool = False
    # sampling host-profiler rate (Hz; 0 = no profiler thread) and the
    # device trace (ms of torch.profiler timeline) a triggered dump takes
    obs_profile_hz: float = 0.0
    obs_profile_trace_ms: float = 0.0
    # query accounting: the principal queries are metered as ("" ->
    # "anonymous"), a cooperative per-query deadline (0 = none), the
    # JSONL audit spool ("" = in memory only) and its rotation bounds
    principal: str = ""
    query_deadline_ms: float = 0.0
    audit_path: str = ""
    audit_rotate_bytes: int = 0
    audit_retain: int = 8
    # device-memory plane: live-byte budget (0 = unlimited), the
    # pressure fraction past which the streamed executor halves its next
    # chunk, and the ledger's switch (env MOSAIC_TPU_MEMWATCH=0 pins off)
    mem_budget_bytes: int = 0
    mem_pressure_high: float = 0.85
    obs_mem_enabled: bool = True
    # telemetry spool ("" = none), the spool age past which the
    # aggregator flags a worker stale, the window of series each spool
    # carries and how many recorder events ride along
    obs_fleet_dir: str = ""
    obs_fleet_stale_ms: float = 5_000.0
    obs_fleet_window_ms: float = 300_000.0
    obs_fleet_events: int = 512
    # learned planner coefficients persisted here ("" = in process
    # only; env MOSAIC_TPU_PLANNER_STATS takes precedence)
    planner_stats_path: str = ""
    # SQLSession.sql() calls slower than this many ms dump the flight
    # recorder; 0 disables the trigger
    obs_slow_query_ms: float = 0.0
    # whole-query fusion (perf/fusion.py): the master switch and the
    # member-operator cap of a group
    fusion_enabled: bool = True
    fusion_max_ops: int = 8
    # workload history (obs/history.py): directory ("" = off), open
    # segment bounds (bytes; age in ms, 0 = none), closed segments kept,
    # compaction window width in ms
    history_dir: str = ""
    history_segment_bytes: int = 1_048_576
    history_segment_age_ms: float = 0.0
    history_retain: int = 64
    history_window_ms: float = 3_600_000.0
    # query server (serve/): listen port, worker threads, queue depth,
    # per-principal quotas (0 disables), default deadline and drain
    # grace; the micro-batcher's window, batch size cap (0 = off) and
    # batchable table-size cap
    serve_port: int = 0
    serve_workers: int = 4
    serve_queue_depth: int = 64
    serve_quota_concurrency: int = 8
    serve_quota_qps: float = 0.0
    serve_deadline_ms: float = 0.0
    serve_drain_ms: float = 5_000.0
    serve_batch_window_ms: float = 2.0
    serve_batch_max: int = 32
    serve_batch_rows_max: int = 4_096
    # serving fleet (serve/supervisor.py, serve/scoreboard.py): worker
    # processes, runtime dir ("" = temp), crash-loop breaker, health
    # tick (0 = no thread), dead-claim reap interval, scoreboard slots
    serve_fleet_workers: int = 2
    serve_fleet_dir: str = ""
    serve_fleet_restart_max: int = 5
    serve_fleet_restart_window_ms: float = 30_000.0
    serve_fleet_health_ms: float = 250.0
    serve_fleet_reap_ms: float = 1_000.0
    serve_scoreboard_slots: int = 512

    @staticmethod
    def from_confs(confs: dict) -> "MosaicConfig":
        """Build from a reference-style string conf map.

        Every known key is validated — a bad value raises
        :class:`ConfigError` naming the key; unknown keys are ignored
        (reference behaviour: Spark confs are an open namespace)."""
        cfg = MosaicConfig()
        for key in confs:
            if key in _CONF_FIELDS or \
                    key.startswith(MOSAIC_PLANNER_FORCE_PREFIX):
                cfg = apply_conf(cfg, key, confs[key])
        return cfg


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


def _as_device_dtype(key: str, value) -> str:
    s = str(value).strip().lower()
    if s not in ("float32", "float64"):
        raise ConfigError(f"{key}={value!r} unsupported "
                          "(float32 or float64)")
    return s


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


def _as_hz(key: str, value) -> float:
    try:
        hz = float(str(value).strip())
    except (TypeError, ValueError):
        raise ConfigError(
            f"{key}={value!r} is not a rate in Hz") from None
    if hz < 0:
        raise ConfigError(f"{key}={hz} must be >= 0 (0 disables)")
    return hz


def _as_bytes(key: str, value) -> int:
    try:
        n = int(str(value).strip())
    except (TypeError, ValueError):
        raise ConfigError(
            f"{key}={value!r} is not a byte count") from None
    if n < 0:
        raise ConfigError(f"{key}={n} must be >= 0 (0 = unlimited)")
    return n


def _as_fraction(key: str, value) -> float:
    try:
        f = float(str(value).strip())
    except (TypeError, ValueError):
        raise ConfigError(
            f"{key}={value!r} is not a fraction") from None
    if not 0.0 < f <= 1.0:
        raise ConfigError(f"{key}={f} must be in (0, 1]")
    return f


def _as_str(key: str, value) -> str:
    return str(value)


def _as_port(key: str, value) -> int:
    try:
        n = int(str(value).strip())
    except (TypeError, ValueError):
        raise ConfigError(
            f"{key}={value!r} is not a port number") from None
    if not 0 <= n <= 65535:
        raise ConfigError(f"{key}={n} must be in [0, 65535] "
                          "(0 = ephemeral)")
    return n


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
    MOSAIC_INDEX_SYSTEM: ("index_system", _as_str),
    MOSAIC_GEOMETRY_API: ("geometry_api", _as_str),
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
    MOSAIC_DEVICE_DTYPE: ("device_dtype", _as_device_dtype),
    MOSAIC_EXACT_FALLBACK: ("exact_fallback", _as_flag),
    MOSAIC_JIT_CACHE_DIR: ("jit_cache_dir", _as_str),
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
    MOSAIC_TRACE_ENABLED: ("trace_enabled", _as_flag),
    MOSAIC_METRICS_ENABLED: ("metrics_enabled", _as_flag),
    MOSAIC_OBS_DUMP_COOLDOWN_MS: ("obs_dump_cooldown_ms", _as_millis),
    MOSAIC_OBS_SAMPLE_MS: ("obs_sample_ms", _as_millis),
    MOSAIC_OBS_SLO_DUMP: ("obs_slo_dump", _as_flag),
    MOSAIC_OBS_PROFILE_HZ: ("obs_profile_hz", _as_hz),
    MOSAIC_OBS_PROFILE_TRACE_MS: ("obs_profile_trace_ms", _as_millis),
    MOSAIC_PRINCIPAL: ("principal", _as_str),
    MOSAIC_QUERY_DEADLINE_MS: ("query_deadline_ms", _as_millis),
    MOSAIC_AUDIT_PATH: ("audit_path", _as_str),
    MOSAIC_AUDIT_ROTATE_BYTES: ("audit_rotate_bytes", _as_bytes),
    MOSAIC_AUDIT_RETAIN: ("audit_retain", _as_count),
    MOSAIC_MEM_BUDGET_BYTES: ("mem_budget_bytes", _as_bytes),
    MOSAIC_MEM_PRESSURE_HIGH: ("mem_pressure_high", _as_fraction),
    MOSAIC_OBS_MEM_ENABLED: ("obs_mem_enabled", _as_flag),
    MOSAIC_OBS_FLEET_DIR: ("obs_fleet_dir", _as_str),
    MOSAIC_OBS_FLEET_STALE_MS: ("obs_fleet_stale_ms", _as_millis),
    MOSAIC_OBS_FLEET_WINDOW_MS: ("obs_fleet_window_ms", _as_millis),
    MOSAIC_OBS_FLEET_EVENTS: ("obs_fleet_events", _as_count),
    MOSAIC_PLANNER_STATS_PATH: ("planner_stats_path", _as_str),
    MOSAIC_OBS_SLOW_QUERY_MS: ("obs_slow_query_ms", _as_millis),
    MOSAIC_FUSION_ENABLED: ("fusion_enabled", _as_flag),
    MOSAIC_FUSION_MAX_OPS: ("fusion_max_ops", _as_blocksize),
    MOSAIC_HISTORY_DIR: ("history_dir", _as_str),
    MOSAIC_HISTORY_SEGMENT_BYTES: ("history_segment_bytes", _as_blocksize),
    MOSAIC_HISTORY_SEGMENT_AGE_MS: ("history_segment_age_ms", _as_millis),
    MOSAIC_HISTORY_RETAIN: ("history_retain", _as_count),
    MOSAIC_HISTORY_WINDOW_MS: ("history_window_ms", _as_millis),
    MOSAIC_SERVE_PORT: ("serve_port", _as_port),
    MOSAIC_SERVE_WORKERS: ("serve_workers", _as_blocksize),
    MOSAIC_SERVE_QUEUE_DEPTH: ("serve_queue_depth", _as_blocksize),
    MOSAIC_SERVE_QUOTA_CONCURRENCY: ("serve_quota_concurrency",
                                     _as_count),
    MOSAIC_SERVE_QUOTA_QPS: ("serve_quota_qps", _as_hz),
    MOSAIC_SERVE_DEADLINE_MS: ("serve_deadline_ms", _as_millis),
    MOSAIC_SERVE_DRAIN_MS: ("serve_drain_ms", _as_millis),
    MOSAIC_SERVE_BATCH_WINDOW_MS: ("serve_batch_window_ms", _as_millis),
    MOSAIC_SERVE_BATCH_MAX: ("serve_batch_max", _as_count),
    MOSAIC_SERVE_BATCH_ROWS_MAX: ("serve_batch_rows_max",
                                  _as_blocksize),
    MOSAIC_SERVE_FLEET_WORKERS: ("serve_fleet_workers", _as_blocksize),
    MOSAIC_SERVE_FLEET_DIR: ("serve_fleet_dir", _as_str),
    MOSAIC_SERVE_FLEET_RESTART_MAX: ("serve_fleet_restart_max",
                                     _as_blocksize),
    MOSAIC_SERVE_FLEET_RESTART_WINDOW_MS:
        ("serve_fleet_restart_window_ms", _as_millis),
    MOSAIC_SERVE_FLEET_HEALTH_MS: ("serve_fleet_health_ms",
                                   _as_millis),
    MOSAIC_SERVE_FLEET_REAP_MS: ("serve_fleet_reap_ms", _as_millis),
    MOSAIC_SERVE_SCOREBOARD_SLOTS: ("serve_scoreboard_slots",
                                    _as_blocksize),
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
    does not know raises ``ConfigError``.  The assignment is a ``config``
    flight-recorder event, so a dump shows which setting preceded a
    failure."""
    # lazy import: obs reads this module back for bundle snapshots
    from .obs.recorder import recorder
    if key.startswith(MOSAIC_PLANNER_FORCE_PREFIX):
        new = _apply_planner_force(cfg, key, value)
        recorder.record("config", key=key, value=str(value))
        return new
    if key not in _CONF_FIELDS:
        raise ConfigError(
            f"unknown conf key {key!r} (known: "
            f"{', '.join(sorted(_CONF_FIELDS))} and "
            f"{MOSAIC_PLANNER_FORCE_PREFIX}<op>)")
    field, coerce = _CONF_FIELDS[key]
    coerced = coerce(key, value)
    recorder.record("config", key=key, value=str(value))
    return dataclasses.replace(cfg, **{field: coerced})


_default_config: MosaicConfig = MosaicConfig()


def set_default_config(cfg: MosaicConfig) -> None:
    global _default_config
    _default_config = cfg
    # conf-driven observability (one-way: never disables an instrument
    # the env or an explicit enable() turned on); the sampler cadence
    # and the profiler rate route through here too (change-detecting,
    # env-pinned: obs.timeseries.configure_sampler,
    # obs.profiler.configure_profiler)
    if cfg.trace_enabled or cfg.metrics_enabled or cfg.obs_sample_ms \
            or cfg.obs_profile_hz:
        from .obs import configure
        configure(cfg)
    else:
        from .obs.timeseries import configure_sampler
        configure_sampler(0.0)
        from .obs.profiler import configure_profiler
        configure_profiler(0.0)
    if cfg.jit_cache_dir:
        from .perf.jit_cache import configure_persistent_cache
        configure_persistent_cache(cfg.jit_cache_dir)
    if cfg.planner_stats_path:
        from .sql.planner import planner
        planner.configure_stats(cfg.planner_stats_path)


def default_config() -> MosaicConfig:
    return _default_config
