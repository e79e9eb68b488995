"""The benchmark of the PyTorch and CUDA port (``cv_monoslam_tpu_torch``):
``python3 slambench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` (``run.py``)."""
