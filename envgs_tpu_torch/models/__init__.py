"""Model-layer registrations (port of envgs_tpu/models/__init__.py): every
name the JAX package registers in SAMPLERS, NETWORKS, EMBEDDERS, REGRESSORS
and RENDERERS, mapped to the port's counterpart, so a config's `type:`
builds the same component by name (`Registry.build` filters the config's
keys by the constructor's signature, as the JAX package's does).

The names are registered lazily (`Registry.register_lazy`): a model module
is imported when its name is first built, not with this package, whose
modules import one another's (the families' step helpers, the trainer).
"""
from envgs_tpu_torch.engine import (
    EMBEDDERS,
    NETWORKS,
    REGRESSORS,
    RENDERERS,
    SAMPLERS,
)

_M = "envgs_tpu_torch.models."

for _reg, _names in (
    # easyvolcap/models/samplers/
    (SAMPLERS, {
        "EnvGSSampler": "envgs:EnvGSConfig",
        "Gaussian2DSampler": "envgs:EnvGSConfig",  # the base-pass subset
        "GaussianTSampler": "gaussiant:GaussianTConfig",
        "UniformSampler": "nerf:uniform_z_vals",
        "ImportanceSampler": "nerf:importance_z_vals",
        "CostVolumeSampler": "enerf:ENeRFConfig",
        "PointPlanesSampler": "point_planes:PointPlanesConfig",
        "STGSModel": "stgs:STGSConfig",  # the spacetime Gaussians
        "FDGSSampler": "stgs:STGSConfig",  # the fdgs render alias
    }),
    # easyvolcap/models/networks/
    (NETWORKS, {
        "VolumetricVideoNetwork": "nerf:NerfConfig",
        "MultilevelNetwork": "nerf:NerfConfig",  # separate_levels=True
        "NeusNetwork": "neus:NeusConfig",
    }),
    # easyvolcap/models/networks/embedders/
    (EMBEDDERS, {
        "PositionalEncodingEmbedder": "embedders:positional_encoding",
        "AnnealPositionalEncodingEmbedder": "embedders:positional_encoding",
        "HashEmbedder": "embedders:HashEmbedder",
        "TcnnHashEmbedder": "embedders:HashEmbedder",  # the same math
        "LatentCodeEmbedder": "embedders:LatentCodeEmbedder",
        "ComposedXyztEmbedder": "embedders:composed_xyzt",
        "KPlanesEmbedder": "embedders:KPlanesEmbedder",
        "DeformationEmbedder": "embedders:DeformationEmbedder",
        "ImageBasedEmbedder": "embedders:ibr_embedder",
        "GeometryImageBasedEmbedder": "embedders:ibr_embedder",
        "EmptyEmbedder": "embedders:empty_embedder",
        "NoopEmbedder": "embedders:noop_embedder",
        "TcnnDirEmbedder": "embedders:sh_dir_encoding",  # SH encoding
        "SpacetimeEmbedder": "embedders:SpacetimeEmbedder",
        "DepthEmbedder": "embedders:depth_embedder",
    }),
    # easyvolcap/models/networks/regressors/
    (REGRESSORS, {
        "MlpRegressor": "regressors:MLP",
        "TcnnMlpRegressor": "regressors:MLP",  # the same math
        "SplitRegressor": "regressors:SplitRegressor",
        "TcnnSplitRegressor": "regressors:SplitRegressor",
        "SphericalHarmonics": "regressors:spherical_harmonics_apply",
        "ContractRegressor": "regressors:contract",
        "EmptyRegressor": "regressors:empty_regressor",
        "NoopRegressor": "regressors:noop_regressor",
        "ZeroRegressor": "regressors:zero_regressor",
        "DisplacementRegressor": "regressors:DisplacementRegressor",
        "ResidualRegressor": "regressors:ResidualRegressor",
        "SE3Regressor": "regressors:SE3Regressor",
        "ImageBasedRegressor": "regressors:ImageBasedRegressor",
        "ImageBasedSphericalHarmonics":
            "regressors:ImageBasedSphericalHarmonics",
        "SDFRegressor": "neus:NeusConfig",  # the SDF field lives here
        "ColorRegressor": "neus:NeusConfig",
        "SingleVarianceRegressor": "neus:NeusConfig",  # inv_s
    }),
    # easyvolcap/models/renderers/
    (RENDERERS, {"VolumeRenderer": "nerf:volume_render"}),
):
    for _name, _target in _names.items():
        _reg.register_lazy(_name, _M + _target)
