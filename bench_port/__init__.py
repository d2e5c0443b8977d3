"""The benchmark of slam_toolbox_tpu_torch (the PyTorch and CUDA port).

Run one cell: python3 bench_port/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>. BENCHMARK.json at the repository's root names
the cells, their configurations (bench_port/configs/), their traffic
mixes (bench_port/traffic/) and the metrics (bench_port/metrics/); the
harness finds each file by its name there.
"""
