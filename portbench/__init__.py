"""The benchmark of the PyTorch and CUDA port (``repro_torch``): a
data-driven harness (``run.py``, ``harness.py``), its yardstick (stream
generation, the plain reference, the work formula, the device-trace
reduction) and one file per configuration, traffic mix and metric."""
