"""The port's command-line scripts (counterparts of the JAX package's
top-level ``cli_*.py`` and ``example.py``), run as ``python -m
any4_tpu_torch.cli.<name>``. Each runs on the GPU unless given ``--cpu``."""
