"""The models' layers (port of ``repro.nn``): ``module`` (seeded inits,
counts), ``layers`` (dense, norms, embedding, softcap), ``rope``,
``attention`` (the ``mha`` kernel route and the scan, KV-cache decode),
``moe`` (SwiGLU, capacity-dispatch MoE) and ``embedding_bag`` (the fused
recsys table)."""
