"""The benchmark of the PyTorch and CUDA port (``path_tracing_tpu_torch``):
one command runs one cell of ``BENCHMARK.json`` once on a CUDA card.

    python3 -m benchmark.run --workload cornell-pt-1080p --seed 7 \\
        --seconds 30 --trace 0

See ``benchmark/README.md``.  Nothing here imports JAX or the JAX package;
``reference/`` imports nothing of the port."""
