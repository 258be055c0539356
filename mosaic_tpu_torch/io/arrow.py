"""Arrow interchange: the control-plane boundary for external engines.

Port copy of ``mosaic_tpu.io.arrow`` (pure Python; ``pyarrow``
is imported only when a function is called).

Reference counterpart: P8 in SURVEY.md — the reference's control plane
is py4j (Python -> JVM) + JNI (JVM -> C); the BASELINE north star names
Arrow record batches as the TPU-native hand-off so a Spark (or any
JVM/native) job can feed this framework without touching Python object
protocols: tessellation output (chips) and join inputs/outputs travel
as columnar Arrow tables / IPC streams.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.geometry.wkb import read_wkb, write_wkb
from ..types import ChipSet

__all__ = ["chips_to_arrow", "chips_from_arrow", "table_to_ipc",
           "table_from_ipc"]


def _pa():
    try:
        import pyarrow
        return pyarrow
    except ImportError as e:
        raise RuntimeError(
            "pyarrow is required for the Arrow interchange surface"
        ) from e


def chips_to_arrow(chips: ChipSet):
    """ChipSet -> Arrow table(geom_id, cell_id, is_core, wkb) — the
    reference's ChipType row schema (is_core, index_id, wkb),
    columnarized."""
    pa = _pa()
    wkb = write_wkb(chips.geoms)
    return pa.table({
        "geom_id": pa.array(chips.geom_id, pa.int64()),
        "cell_id": pa.array(chips.cell_id, pa.int64()),
        "is_core": pa.array(chips.is_core, pa.bool_()),
        "wkb": pa.array(wkb, pa.binary()),
    })


def chips_from_arrow(table) -> ChipSet:
    geoms = read_wkb([bytes(b) for b in table["wkb"].to_pylist()])
    return ChipSet(
        np.asarray(table["geom_id"].to_numpy(zero_copy_only=False)),
        np.asarray(table["cell_id"].to_numpy(zero_copy_only=False)),
        np.asarray(table["is_core"].to_numpy(zero_copy_only=False)),
        geoms)


def table_to_ipc(table) -> bytes:
    """Arrow table -> IPC stream bytes (what crosses the process
    boundary to/from a Spark sidecar)."""
    pa = _pa()
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue().to_pybytes()


def table_from_ipc(blob: bytes):
    pa = _pa()
    with pa.ipc.open_stream(pa.BufferReader(blob)) as r:
        return r.read_all()
