"""Checkpointing of the trainer (port of ``repro.checkpoint``)."""
