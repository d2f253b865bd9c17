"""The benchmark of the PyTorch/CUDA port (``gatk_hc_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once, on the card:

    python3 -m hcbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data.  A cell names a configuration
(``hcbench/configs/<name>.json``, the deployment's sizes) and a traffic mix
(``hcbench/traffic/<name>.json``, the parameters the one generator reads);
the mix names its driver (``hcbench/drivers/<name>.py``, the code that
builds the system under test and drives its window); every metric is a
reader of its own (``hcbench/metrics/<name>.py``).  A later cell, mix or
metric is a new file and a new entry, never an edit.

The yardstick lives here: the generator (``gen.py``), the plain PairHMM
reference and the comparison that decides ``correct`` (``reference.py``),
the work and roofline count with the card's published peaks
(``roofline.py``) and the reduction of the profiler's trace
(``trace.py``).  None of them imports the port; the drivers import the
port and nothing else of the repository.  Nothing here imports ``jax`` or
the JAX package (``hcbench/tests/test_hcbench_spec.py`` checks).
"""
