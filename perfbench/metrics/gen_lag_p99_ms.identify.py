"""gen_lag_p99_ms.identify: the 99th percentile of how late the load
generator sent a request after it was due, in ms."""

from perfbench.stats import percentile


def read(ctx):
    lags = ctx.entry.get("lag_ms", [])
    return percentile(lags, 99) if lags else None
