"""One reader per metric, ``<metric name>.py``, loaded by file name (a name
may hold dots). Each has ``read(readings) -> float | None``
(harness.Readings); None leaves the metric out of the line."""
