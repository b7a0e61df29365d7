"""The benchmark of subread_tpu_torch: `python3 -m benchmark.run --workload
<name> --seed <n> --seconds <s> --trace <0|1>` (README.md)."""
