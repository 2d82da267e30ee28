"""The benchmark of mfmg_torch, the PyTorch and CUDA port: a harness driven
by BENCHMARK.json (run.py, core.py), the system under test (system.py), one
load generator (loadgen.py), profiler readings (trace.py, layers.py), the
frozen yardstick (work.py), the plain reference (reference/) and, per cell,
data files (configs/, traffic/, limits/) and metric readers (metrics/)."""
