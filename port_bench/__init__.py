"""The benchmark of the PyTorch/CUDA port (`texir_code_tpu_torch`).

One command runs one cell once, on the card it is started on:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are data: the
harness finds them by the names in BENCHMARK.json (configs/<name>.json,
traffic/<name>.json, metrics/<name>.py).  Nothing here imports JAX or the
JAX package; the reference (reference/) imports nothing of the port.
"""
