"""PyTorch/CUDA port of the COCS hierarchical federated learning system.

Mirrors the JAX reference package ``repro`` path for path, slice by
slice, with hand-written CUDA kernels for the H100 in ``csrc/``. Imports
``torch`` and numpy only.

The entry point is the reference's facade: ``repro_torch.run(spec)``
takes an ``api.ExperimentSpec`` or an ``api.ExperimentGrid`` (the same
JSON as ``repro.run``) and runs tiers 1-4 on the host env (``envs``,
float64 numpy) or the device env (``sim``); the LM serve slice is
``launch.serve``. Entry points run on CUDA unless given
``device="cpu"``.
"""


def __getattr__(name: str):
    # the facade, imported on first use so that ``import repro_torch``
    # stays light
    if name == "run":
        from repro_torch.api import run
        return run
    if name == "api":
        import importlib
        return importlib.import_module("repro_torch.api")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
