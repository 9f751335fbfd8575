"""k2c_roofline.identify: K2c's share of its roofline, in percent: per
query one probe against the gallery's rows of 512 int8 (the gallery and
its norms read once, the probe read once, a distance and an index written),
bound by bytes at 3.35 TB/s, over the device time of K2c's sweep
(``knn_int8_wgmma_kernel``) and its reduction (``knn_reduce_kernel``) in
the trace; a query is one sweep launch."""

from perfbench import flops
from perfbench.readers import roofline


def read(ctx):
    m, n, d = ctx.entry["knn_shape"]
    ops, nbytes = flops.knn_int8_work(m, n, d)
    return roofline(ctx,
                    lambda k: "knn_int8_wgmma_kernel" in k or "knn_reduce_kernel" in k,
                    lambda k: "knn_int8_wgmma_kernel" in k,
                    lambda calls: [(nbytes, ops, "int8")] * calls)
