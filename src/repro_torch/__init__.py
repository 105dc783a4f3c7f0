"""PyTorch + CUDA port of the fast approximate eigenspace system.

A second package beside the JAX reference ``repro``: it imports torch and
numpy only.  Its entry points take ``device=`` and default to "cuda";
the symmetric (undirected-graph) FGFT fit and tiered serving are ported,
with the staged G-chain kernels hand-written in CUDA C++ (csrc/).
"""
