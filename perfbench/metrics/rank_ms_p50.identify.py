"""rank_ms_p50.identify: the median time of ``EnrollmentGallery.identify``
on the ranking thread, from its submission until its answer (the
benchmark's span), in ms."""

from perfbench.readers import span_percentile_ms


def read(ctx):
    return span_percentile_ms(ctx, "identify", 50)
