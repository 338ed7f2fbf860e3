"""The benchmark of imageprocessor_tpu_torch, the PyTorch and CUDA port.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the card (run.py). BENCHMARK.json
at the repository's root names the cells; spec.py finds each cell's
configuration, traffic and metrics by name.
"""
