"""Optimizer and learning-rate schedules of the trainer (port of
``repro.optim``): ``adamw`` (AdamW with dtype-controlled moments, updated
in place) and ``schedules`` (cosine and WSD)."""
