"""K4 (trace_blend_bwd.cu), no aux channel, against its roofline on the
reference's trace walks of its forward (counts_trace.py)."""
from benchmark import counts_trace
from benchmark.shares import roofline


def read(ctx):
    return roofline(ctx, "trace_blend_bwd_kernel", ("0",),
                    lambda w: w["blend"] == "trace" and w["train"]
                    and w["A"] == 0, counts_trace.trace_bwd)
