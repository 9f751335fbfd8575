"""reruns_per_photo.album: lanes that ``analyze_batch`` re-ran one by one
through ``FacialAnalyzer.analyze`` (counted by the benchmark's wrapper of
that method), per photo returned in the window."""


def read(ctx):
    photos = ctx.entry.get("photos", 0)
    return sum(ctx.entry["reruns"]) / photos if photos else None
