"""PyTorch/CUDA port of the recursive-query engine (``repro``).

Same sub-package layout as the JAX package: ``graph`` (host builders that
return tensors), ``core`` (IFE engine, extension backends, policies,
single-device dispatcher), ``kernels`` (hand-written CUDA kernels with
their plain PyTorch versions), ``runtime`` (engine cache, two-phase
hybrid, admission, the trainer's fault tolerance), ``configs``, ``nn`` and
``models`` (the LM and GNN families; ``graph.sampler`` samples the GNNs'
minibatches), ``optim``, ``data`` and ``checkpoint`` (the trainer's
substrate) and ``launch`` (the serving and training drivers, the GNN
train steps).

Entry points run on ``cuda`` unless the caller asks for the CPU; this
package never imports JAX.
"""
