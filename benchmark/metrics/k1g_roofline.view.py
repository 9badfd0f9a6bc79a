"""K1 (raster_blend_fwd.cu) in the gauss3d mode against its roofline: a
3DGS render launches it in no other configuration."""
from benchmark.shares import roofline


def read(ctx):
    return roofline(ctx, "raster_blend_fwd_kernel", None,
                    lambda w: w["blend"] == "raster"
                    and w["mode"] == "gauss3d",
                    ctx.counts.raster_fwd)
