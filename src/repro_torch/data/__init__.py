"""The port's deterministic, resumable synthetic token pipeline."""
