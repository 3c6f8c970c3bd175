"""The benchmark of `rlap_tpu_torch`, the PyTorch and CUDA port.

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the machine it is
started on and prints one JSON line. Configurations, traffic mixes,
metrics, recipes and limits are files of their own under this folder,
found by the names in `BENCHMARK.json` (see `harness.py`).
"""
