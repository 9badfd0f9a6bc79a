"""K2 (raster_blend_bwd.cu) in the surfel mode against its roofline."""
from benchmark.shares import roofline


def read(ctx):
    return roofline(ctx, "raster_blend_bwd_kernel", ("0",),
                    lambda w: w["blend"] == "raster"
                    and w["mode"] == "surfel"
                    and w["aligned"],
                    ctx.counts.raster_bwd)
