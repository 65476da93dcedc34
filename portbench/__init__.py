"""The benchmark of the PyTorch and CUDA port of consensus clustering
(``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``); see ``BENCHMARK.json`` at the repository root."""
