"""Parallelism across ranks beyond the query engines (port of
``repro.parallel``): ``pipeline`` (GPipe-style pipeline stages over a
mesh axis)."""
