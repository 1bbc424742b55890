"""Entry points of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``."""
