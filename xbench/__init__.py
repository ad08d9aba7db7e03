"""The benchmark of the PyTorch and CUDA X-engine
(``caltech_bifrost_dsp_tpu_torch``).

``python3 -m xbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line (a
configuration of two pipelines on one card runs them as two processes,
:mod:`xbench.pair`).  Every cell, configuration, traffic mix, product
sink and per-layer metric is a file of its own, found by name
(:mod:`xbench.spec`)."""
