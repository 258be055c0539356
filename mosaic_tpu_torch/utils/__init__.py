"""Helpers beside the port's planes: the tracing shim (``utils.trace``)
and result export (``utils.viz``)."""
