"""Training data: the deterministic token pipeline."""
