"""The benchmark harness of slepc_tpu_torch: one command runs one cell once
(``portbench/run.py``)."""
