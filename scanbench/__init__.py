"""scanbench: the benchmark of aho_corasick_1975_tpu_torch on one NVIDIA
H100 (``python3 scanbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``; the cells are in ``BENCHMARK.json``)."""
