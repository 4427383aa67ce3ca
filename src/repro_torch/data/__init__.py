"""Deterministic synthetic data streams of the trainer (port of
``repro.data``)."""
