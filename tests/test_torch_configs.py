"""The port's config tuples against the JAX package's, and the strict
config reader of the port's command line.

Every NamedTuple of options the port has is held to the JAX tuple of the
same name: the same field names, in the same order, with the same defaults.
What the port leaves out is listed here, field by field, with its reason; a
field missing from both lists fails the test. What the port adds comes
after the JAX fields, listed in ADDED with its default and its reason.

    python -m pytest tests/test_torch_configs.py
"""
import importlib
import os

import pytest

from envgs_tpu_torch import cli
from envgs_tpu_torch.engine import load_config

# (module below both packages, tuple) -> {field the port leaves out: why}
TUPLES = {
    ("models.envgs", "EnvGSConfig"): {},
    ("train.supervisor", "LossConfig"): {},
    ("train.trainer", "ScheduleConfig"): {},
    ("models.gaussians", "DensifyConfig"): {},
    ("train.optimizer", "LRConfig"): {},
    ("train.trainer", "CamOptConfig"): {},
    ("models.gaussiant", "GaussianTConfig"): {},
    ("models.stgs", "STGSConfig"): {},
    ("models.point_planes", "PointPlanesConfig"): {},
    ("models.nerf", "NerfConfig"): {},
    ("models.neus", "NeusConfig"): {},
    ("models.enerf", "ENeRFConfig"): {},
}
# (module, tuple) -> {field the port adds: (default, why)}
ADDED = {
    ("models.envgs", "EnvGSConfig"): {
        "env_per_tile_cap": (None, "the env cull's per-tile cap, counted "
                             "when it cuts; None: the JAX package's 2048"),
    },
}


@pytest.mark.parametrize("mod,name", sorted(TUPLES))
def test_config_tuple_has_the_jax_fields_and_defaults(mod, name):
    want = getattr(importlib.import_module(f"envgs_tpu.{mod}"), name)
    got = getattr(importlib.import_module(f"envgs_tpu_torch.{mod}"), name)
    omitted = TUPLES[(mod, name)]
    added = ADDED.get((mod, name), {})
    assert set(omitted) <= set(want._fields), "an omission names no field"
    assert not set(omitted) & set(got._fields), "listed as omitted, but there"
    assert not set(added) & set(want._fields), "listed as added, but JAX's"
    assert list(got._fields) == [f for f in want._fields
                                 if f not in omitted] + list(added)
    assert got._field_defaults == {
        **{k: v for k, v in want._field_defaults.items() if k not in omitted},
        **{k: v[0] for k, v in added.items()}}


def test_cli_omissions_are_the_listed_backend_names():
    """The backend names are fields of the tuples now: no tuple leaves one
    out, and the command line sets none aside; it reads them into the
    tuples as every other key."""
    listed = {f for om in TUPLES.values() for f in om if "backend" in f}
    assert listed == set() and not hasattr(cli, "OMITTED_KEYS")
    assert {"raster_backend", "tracer_backend"} <= cli._sampler_keys()


def test_named_raises_on_an_unknown_key_by_name():
    from envgs_tpu_torch.models.envgs import EnvGSConfig

    cfg = cli._named(EnvGSConfig, {"specular_threshold": 0.25,
                                   "raster_backend": "ref"})
    assert cfg.specular_threshold == 0.25 and cfg.raster_backend == "ref"
    with pytest.raises(KeyError, match="specular_treshold"):
        cli._named(EnvGSConfig, {"specular_treshold": 0.25})
    with pytest.raises(KeyError, match="raster_backnd"):
        cli._named(EnvGSConfig, {"raster_backnd": "pallas"})


def _synthetic_config(*overrides):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(
        "configs/exps/envgs_synthetic.yaml", root=root,
        overrides=["model_cfg.sampler_cfg.tracer_backend=tiled",
                   "dataset_cfg.H=16", "dataset_cfg.W=16",
                   "dataset_cfg.n_views=2", *overrides])


def test_shipped_config_builds_and_carries_specular_threshold():
    out = cli.build_from_config(_synthetic_config(
        "model_cfg.sampler_cfg.specular_threshold=0.5"), "cpu")
    assert out[4].specular_threshold == 0.5


@pytest.mark.parametrize("key", [
    "model_cfg.sampler_cfg.specular_treshold",
    "model_cfg.sampler_cfg.env_densify_grad_treshold",
    "model_cfg.supervisor_cfg.img_loss_wieght"])
def test_build_from_config_raises_on_a_key_nothing_reads(key):
    with pytest.raises(KeyError, match=key.rsplit(".", 1)[1]):
        cli.build_from_config(_synthetic_config(f"{key}=1"), "cpu")


def _shipped(name, *overrides):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(f"configs/exps/{name}.yaml", root=root,
                       overrides=list(overrides))


def test_shipped_envgs_synthetic_config_builds_as_shipped():
    """configs/exps/envgs_synthetic.yaml names the `ref` tracer: it builds
    through the command line's reader as shipped (views cut to 16 x 16 for
    time), and its EnvGSConfig carries the oracle."""
    out = cli.build_from_config(_shipped(
        "envgs_synthetic", "dataset_cfg.H=16", "dataset_cfg.W=16",
        "dataset_cfg.n_views=2"), "cpu")
    assert out[4].tracer_backend == "ref" and out[4].raster_backend == "pallas"


def test_shipped_gaussiant_synthetic_config_reads_its_ref_backend():
    """configs/exps/gaussiant_synthetic.yaml names the `ref` rasterizer: the
    3DGS entry point's reader takes it into GaussianTConfig as shipped."""
    from envgs_tpu_torch.models.gaussiant import GaussianTConfig
    from envgs_tpu_torch.models.gaussians import DensifyConfig

    scfg = _shipped("gaussiant_synthetic")["model_cfg"]["sampler_cfg"]
    gcfg = cli._named(GaussianTConfig, scfg,
                      frozenset(DensifyConfig._fields) | cli._GAUSSIANT_KEYS)
    assert gcfg.raster_backend == "ref"


@pytest.mark.parametrize("key,name", [
    ("model_cfg.sampler_cfg.tracer_backend", "tiled_interp"),
    ("model_cfg.sampler_cfg.raster_backend", "pallas_interp")])
def test_build_from_config_refuses_other_backends_by_name(key, name):
    with pytest.raises(NotImplementedError, match=name):
        cli.build_from_config(_synthetic_config(f"{key}={name}"), "cpu")
