"""PyTorch/CUDA port of the COCS hierarchical federated learning system.

Mirrors the JAX reference package ``repro`` path for path, slice by
slice, with hand-written CUDA kernels for the H100 in ``csrc/``. Imports
``torch`` and numpy only. Entry point of the first slice:
``repro_torch.experiment.sweep.sweep_experiments``.
"""
