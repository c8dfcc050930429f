"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on the card.

`python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once (run.py); harness.py
holds the run, traffic.py the one traffic generator, counting.py the work
and the card's peaks, devtrace.py the device trace, reference/ the plain
references, metrics/ one reader per metric, configs/, traffic/ and limits/
the data each cell names. Nothing here imports JAX or the JAX package.
"""
