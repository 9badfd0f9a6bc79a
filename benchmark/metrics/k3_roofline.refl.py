"""K3 (trace_blend_fwd.cu) in its training configuration, no aux channel,
against its roofline on the reference's trace walks (counts_trace.py)."""
from benchmark import counts_trace
from benchmark.shares import roofline


def read(ctx):
    return roofline(ctx, "trace_blend_fwd_kernel", ("2", "0"),
                    lambda w: w["blend"] == "trace" and w["train"]
                    and w["A"] == 0, counts_trace.trace_fwd)
