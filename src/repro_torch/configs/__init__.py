"""Arch registry of the port (``base``) and its configs, each with its
``full_config`` and ``smoke_config`` in torch dtypes: the LM family
(minicpm-2b, deepseek-coder-33b, olmoe-1b-7b, gemma2-2b,
llama4-maverick), the GNN family (schnet, pna, mace, equiformer-v2),
recsys (dcn-v2) and the paper engine (paper-bfs-engine)."""
