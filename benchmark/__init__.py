"""The benchmark of tpdlp_torch, the PyTorch and CUDA port: one cell a run,
`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`.  See benchmark/README.md."""
