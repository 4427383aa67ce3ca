"""Fused degree-binned pull kernel."""
