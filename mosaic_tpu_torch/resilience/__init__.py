"""Resilience: the codecs' ``on_error`` contract (``ingest``).

Port of the part of ``mosaic_tpu.resilience`` that the GeoTIFF codec
needs; fault injection and retry policies come with the host planes.
"""
