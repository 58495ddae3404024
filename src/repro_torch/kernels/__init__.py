"""Hand-written Hopper kernels, one package per TPU kernel of ``repro``:
``kernel.py`` (the CUDA launcher), ``ops.py`` (the model-facing wrapper)
and ``ref.py`` (the plain PyTorch version)."""
