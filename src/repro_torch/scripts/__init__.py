"""Developer scripts over the port (counterparts of the repository's
``scripts/smoke_models.py``, ``flash_projection.py`` and
``render_experiments.py``): run as

    PYTHONPATH=src python -m repro_torch.scripts.<name> ..."""
