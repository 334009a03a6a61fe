"""Serving: batched generation and embedding (counterpart of ``repro/serve``)."""
