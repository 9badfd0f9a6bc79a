"""The benchmark of envgs_tpu_torch on one NVIDIA H100: a harness driven by
data (BENCHMARK.json at the repository's root, `configs/`, `traffic/`,
`limits/`, `metrics/`), the families' glue into the program, a frozen
plain reference (`reference/`) and the yardstick of work (`counts.py`).
Run a cell with `python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`.
"""
