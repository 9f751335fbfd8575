"""batch_faces_mean.identify: faces per ``extract_batch`` call of the
worker (the benchmark's wrapper that the worker runs as its ``process``),
the mean over the window."""


def read(ctx):
    sizes = ctx.spans.sizes.get("extract_batch", [])
    return sum(sizes) / len(sizes) if sizes else None
