"""The benchmark of tpu_darktable_torch on the card: `python3 isp_bench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` from the root of a
checkout.  The cells, metrics and bounds are in BENCHMARK.json; each
configuration, traffic mix, per-layer metric and hand kernel's work has a
file of its own here, found by its name."""
