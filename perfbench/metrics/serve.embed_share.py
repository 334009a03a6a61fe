"""Share of the window (%) the host spent inside ``EmbeddingServer.embed``
(each call ends in the embedding's read-back), by the benchmark's clock
around each call."""


def read(run):
    t = run.spans.get("embed")
    return sum(t) / run.window_s * 100.0 if t else None
