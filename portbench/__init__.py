"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on one NVIDIA GPU and prints one JSON
line.  Everything that defines a cell is data found by name: the model
configuration in ``configs/<config>.json``, the traffic mix in
``workloads/<traffic>.json`` (read by the generator its ``driver`` names,
``drivers/<driver>.py``), the limits of its correctness check in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  The yardstick (traffic generation, cost
arithmetic, the plain reference, the comparison) lives here; of the port
the benchmark takes only its entry points and the kernel names in the trace.
"""
