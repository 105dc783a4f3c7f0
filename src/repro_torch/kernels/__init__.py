"""Hand-written CUDA kernels (csrc/), their plain PyTorch versions
(``ref``) and the execution plans that dispatch between them."""
