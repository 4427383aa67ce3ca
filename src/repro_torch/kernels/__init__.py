"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel package is ``<name>.py`` (the CUDA launcher and the source
path), ``ops.py`` (the wrapper and host-side operand preparation) and
``ref.py`` (the plain version). Sources live in ``csrc/``; ``build.py``
compiles them with ``nvcc`` on first use.

- binned_pull  : fused degree-binned pull extension (bottom-up step behind
                 ``pull_binned_fused`` / ``dopt_fused``)
- msbfs_extend : MS-BFS block extension (the ``block_mxu`` scan)
"""
