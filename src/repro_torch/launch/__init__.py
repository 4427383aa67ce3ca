"""Entry points of the port (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) and
the mesh of ranks they run on (``launch.mesh``)."""
