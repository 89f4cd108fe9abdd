"""Secure checkpoints of the port."""
