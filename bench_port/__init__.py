"""Benchmark of the PyTorch / CUDA port `video_segment_tpu_torch`.

Run one cell once with `python3 bench_port/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>` from the repository root (README.md).
"""
