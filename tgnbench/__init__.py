"""The benchmark of ``repro_torch``, the PyTorch/CUDA port, serving TGN
fleets on one H100: ``python -m tgnbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the checkout's root. Cells, metrics and
bounds are listed in ``BENCHMARK.json``; each configuration, traffic mix,
per-layer metric and reference family is a file of its own here."""
