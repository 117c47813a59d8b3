"""Ops: the hand-written CUDA kernels with their plain twins, and the trunk and encoder built from them."""
