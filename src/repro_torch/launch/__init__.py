"""Entry points of the port (``python -m repro_torch.launch.serve``) and
the mesh of ranks they run on (``launch.mesh``)."""
