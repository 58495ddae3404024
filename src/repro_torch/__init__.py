"""PyTorch port of the DFabric reproduction, for NVIDIA Hopper (sm_90a).

Mirrors the module layout of the JAX package ``repro`` (the reference) and
imports nothing of it.  Entry points run on the card (``device="cuda"``)
unless the caller asks for the CPU, where every kernel wrapper takes its
plain PyTorch version.
"""
