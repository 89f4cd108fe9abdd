"""Paged secure serving: the protected KV pool and the engine."""
