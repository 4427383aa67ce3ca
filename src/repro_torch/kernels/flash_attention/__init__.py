"""Flash-attention forward kernel."""
