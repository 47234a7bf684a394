"""Host milliseconds the runner waited on the loader for a batch, averaged
over the window's batches (the benchmark's wrapper around the loader's
iterator times each request)."""
UNIT = "ms"


def read(ctx):
    w = ctx.loader_waits_s
    return 1e3 * sum(w) / len(w) if w else None
