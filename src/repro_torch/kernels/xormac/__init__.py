"""NH hash of optBlk payloads (Integ Engine): CUDA kernel, plain version,
ops."""
