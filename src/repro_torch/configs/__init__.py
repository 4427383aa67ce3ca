"""Arch registry of the port (``base``) and the LM configs: minicpm-2b,
deepseek-coder-33b, olmoe-1b-7b, gemma2-2b and llama4-maverick, each with
its ``full_config`` and ``smoke_config`` in torch dtypes."""
