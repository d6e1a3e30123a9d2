"""The benchmark of `repro_torch`, the PyTorch and CUDA port of GenFV.

`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on one CUDA device and
prints one JSON line. Configurations (`configs/`), traffic mixes
(`traffic/`), per-layer metric readers (`metrics/`) and the limits of the
output check (`limits/`) are files found by the names in `BENCHMARK.json`.
`reference/` is the plain PyTorch and NumPy reference the check holds the
program to; it imports nothing of the program.
"""
