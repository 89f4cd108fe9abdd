"""B-AES diversify + XOR (Crypt Engine): CUDA kernel, plain version, ops."""
