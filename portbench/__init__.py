"""The benchmark of ``any4_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric, kernel family, format or architecture is a file of its
own under this folder, found by the name ``BENCHMARK.json`` or the
configuration gives it (:mod:`.spec`).

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package;
``reference/``, ``archs/`` and ``formats/`` import nothing of the port
either.
"""
