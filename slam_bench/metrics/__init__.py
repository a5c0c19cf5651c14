"""One reader a per-layer metric, in a file named after the metric:
`read(readings) -> float | None`. `readings` is what the cell's driver
collected (`drivers/__init__.py`); a reader that finds nothing to read
returns None and the metric is left out of the result line.
"""
