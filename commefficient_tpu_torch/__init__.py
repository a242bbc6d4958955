"""PyTorch/CUDA port of commefficient_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX package, which stays the reference
the port is held against (tests/test_torch_*.py run both on the same
inputs). It imports torch and never jax, and nothing of
commefficient_tpu: where it needs a host module of the JAX package it
keeps its own copy.

What is ported is the FetchSGD round (`--mode sketch` and `--mode
uncompressed`), end to end: config -> data -> model -> client backward
-> count-sketch encode (CUDA kernel) -> server table-space step with the
median estimate, or above d = 32M the sampled-threshold decode (CUDA
kernels) -> weight update and byte accounting. Two drivers run it:
`training/cv_train.py` (ResNet9/CIFAR) and `training/gpt2_train.py`
(GPT2 double heads/PersonaChat, whose attention at 256 tokens and more
runs a CUDA flash-attention forward). Options whose path is not ported
yet are refused loudly by `Config.validate` (ROADMAP.md Queue 1).

Entry points run on the card unless the caller passes
`device="cpu"`; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""
