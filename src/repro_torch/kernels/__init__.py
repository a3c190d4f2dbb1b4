"""Hand-written CUDA kernels, their plain PyTorch versions, and the ops
that dispatch between them by the device of the tensors."""
