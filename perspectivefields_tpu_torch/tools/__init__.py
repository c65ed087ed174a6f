"""Command-line entry points of the port: ``python -m
perspectivefields_tpu_torch.tools.train`` and ``...tools.evaluate``."""
