"""Mean host time of ``Session.plan()`` a batch (ms), from the
benchmark's clock around each call in the window."""


def read(run):
    t = run.spans.get("plan")
    return sum(t) / len(t) * 1e3 if t else None
