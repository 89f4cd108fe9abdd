"""Dense-attention decoder LM in PyTorch (the JAX parameter layout)."""
