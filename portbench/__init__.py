"""The benchmark of the PyTorch and CUDA port (``repro_torch``): PBNG
decompositions and hierarchy queries on one NVIDIA card.  Entry point:
``python3 portbench/run.py`` (see ``BENCHMARK.json`` for the cells)."""
