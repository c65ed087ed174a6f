"""Command-line entry points of the port (``python -m
perspectivefields_tpu_torch.tools.<name>``): ``train``, ``evaluate``,
``learning_proof``, ``convert_checkpoint``, ``export_torch``,
``dryrun_multiprocess`` and ``demo``."""
