"""queue_wait_p50_ms.identify: the median wait of a request in serve's
``_BatchingWorker`` from its enqueue until the worker picks it into a batch
(the worker's own ``queue_wait`` span, through the timer the benchmark
hands it), in ms."""

from perfbench.stats import percentile


def read(ctx):
    waits = ctx.entry.get("stage_ms", {}).get("embed_worker.queue_wait", [])
    return percentile(waits, 50) if waits else None
