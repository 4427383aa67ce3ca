"""Entry points of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``), the GNN family's per-cell train
steps (``launch.steps``) and the mesh of ranks they run on
(``launch.mesh``)."""
