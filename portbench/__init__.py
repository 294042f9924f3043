"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one cell is
one configuration (``configs/``) under one traffic mix (``traffic/``),
run by ``run.py``; see ``BENCHMARK.json`` at the repository's root."""
