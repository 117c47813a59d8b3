"""PyTorch + CUDA port of mdgen_finetune_tpu for one NVIDIA H100.

The JAX package ``mdgen_finetune_tpu`` stays the reference; this package
imports nothing of it and no JAX. Module names mirror the JAX package's.
The TPU kernels on the ported path are hand-written CUDA C++ for sm_90a
(``csrc/``), built at first use; each has a plain PyTorch twin that runs for
CPU tensors.
"""
