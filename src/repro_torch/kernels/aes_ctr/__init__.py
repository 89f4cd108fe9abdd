"""AES-CTR keystream: CUDA kernel, plain version and ops wrappers."""
