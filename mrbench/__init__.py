"""mrbench: the benchmark of the PyTorch/CUDA port (``mapreduce_rust_tpu_torch``).

One run is one process and one cell of ``BENCHMARK.json``:

    python3 -m mrbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It makes a pool of input files from the seed (``gen/``), warms up, runs
word_count jobs back to back through the port's public entry
``runtime.driver.run_job`` for ``--seconds`` (one client, a closed loop),
checks every answer it samples against the plain reference
(``reference/``), and prints one JSON line. Everything that belongs to one
configuration, traffic mix or metric is a file found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``gen/<generator>.py``,
``metrics/<metric>.py``.

Nothing here imports JAX or the JAX package; the harness refuses to print a
result if either was loaded.
"""
