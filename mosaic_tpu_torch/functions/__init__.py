"""The function surface: ``MosaicContext`` and its registry
(``context``, ``raster``, ``registry``, ``docstrings``)."""
