"""Fused B-AES crypt + NH hash: CUDA kernels, plain versions, wrappers."""
