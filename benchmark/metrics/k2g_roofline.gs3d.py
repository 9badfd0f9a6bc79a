"""K2 (raster_blend_bwd.cu) in the gauss3d mode against its roofline."""
from benchmark.shares import roofline


def read(ctx):
    return roofline(ctx, "raster_blend_bwd_kernel", ("1",),
                    lambda w: w["blend"] == "raster"
                    and w["mode"] == "gauss3d",
                    ctx.counts.raster_bwd)
