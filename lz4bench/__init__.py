"""lz4bench: the benchmark of lz4tpu_torch, the PyTorch and CUDA port.

``python3 -m lz4bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (``run.py``).
Nothing here imports ``jax`` or ``lz4tpu``; only ``run.py`` and the ops
import ``lz4tpu_torch``, the system under test.
"""
