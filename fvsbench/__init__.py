"""The benchmark of the PyTorch and CUDA port (`repro_torch`): filtered
top-k search on SIFT-1M- and Cohere-1M-shaped deployments.  Run a cell
with `python3 fvsbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`; see README.md."""
