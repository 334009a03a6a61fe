"""MQRLD platform on PyTorch: lake, queries, index build, engine, planner."""
