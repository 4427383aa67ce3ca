"""Optimizer, learning-rate schedules and gradient compression (port of
``repro.optim``): ``adamw`` (AdamW with dtype-controlled moments, updated
in place), ``schedules`` (cosine and WSD) and ``compression`` (int8
error-feedback compression and its data-parallel sum)."""
