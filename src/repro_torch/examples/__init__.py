"""The user-facing examples on the port, one module each (counterparts of
the repository's ``examples/*.py``): run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

Each keeps its reference's sizes, seeds and printed lines, runs on the
CUDA card unless ``--device`` names another device (without a card and
without ``--device`` it raises), and returns from ``main(argv)`` a dict
of what it printed."""
