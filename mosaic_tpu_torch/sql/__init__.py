"""SQL surface: parser, planner, columnar engine, prettifier and the
layout advisor.

Port of ``mosaic_tpu.sql`` (reference: mosaic/sql/, the MosaicSQL
SparkSessionExtensions and Prettifier): this package supplies the query
engine the reference gets from Spark.
"""

from .engine import (BatchableLookup, SQLError, SQLSession, Table,
                     classify_batchable)
from .parser import SQLParseError, parse
from .prettifier import prettified

__all__ = ["SQLSession", "Table", "SQLError", "SQLParseError", "parse",
           "prettified", "BatchableLookup", "classify_batchable"]
