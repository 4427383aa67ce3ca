"""Entry points of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.dryrun``), the per-cell steps of the GNN and recsys
families and the paper engine's cells (``launch.steps``), their roofline
(``launch.hlo_analysis``) and the mesh of ranks they run on
(``launch.mesh``)."""
