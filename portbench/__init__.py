"""The benchmark of the PyTorch and CUDA port (``madsim_tpu_torch``).

``python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on a CUDA card and prints its
result line. The harness imports torch, numpy and the port, never ``jax``
nor the JAX package; its plain reference (``portbench/reference``)
imports nothing of the port either.
"""
