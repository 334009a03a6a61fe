"""Asynchronous, atomic, integrity-checked checkpoints."""
