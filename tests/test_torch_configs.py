"""The port's config tuples against the JAX package's, and the strict
config reader of the port's command line.

Every NamedTuple of options the port has is held to the JAX tuple of the
same name: the same field names, in the same order, with the same defaults.
What the port leaves out is listed here, field by field, with its reason; a
field missing from both lists fails the test.

    python -m pytest tests/test_torch_configs.py
"""
import importlib
import os

import pytest

from envgs_tpu_torch import cli
from envgs_tpu_torch.engine import load_config

# (module below both packages, tuple) -> {field the port leaves out: why}
TUPLES = {
    ("models.envgs", "EnvGSConfig"): {
        "raster_backend": "no backend switch: the tensors' device picks "
                          "kernel or plain version",
        "tracer_backend": "as raster_backend",
    },
    ("train.supervisor", "LossConfig"): {},
    ("train.trainer", "ScheduleConfig"): {},
    ("models.gaussians", "DensifyConfig"): {},
    ("train.optimizer", "LRConfig"): {
        # ROADMAP.md Queue 1 item 8 (models/stgs.py) brings the temporal
        # fields of GaussianParams and these learning rates with them
        "t": "temporal (STGS) pools are not ported: Queue 1 item 8",
        "scaling_t": "as t",
        "motion": "as t",
    },
    ("train.trainer", "CamOptConfig"): {},
    ("models.gaussiant", "GaussianTConfig"): {
        "raster_backend": "no backend switch",
    },
}


@pytest.mark.parametrize("mod,name", sorted(TUPLES))
def test_config_tuple_has_the_jax_fields_and_defaults(mod, name):
    want = getattr(importlib.import_module(f"envgs_tpu.{mod}"), name)
    got = getattr(importlib.import_module(f"envgs_tpu_torch.{mod}"), name)
    omitted = TUPLES[(mod, name)]
    assert set(omitted) <= set(want._fields), "an omission names no field"
    assert not set(omitted) & set(got._fields), "listed as omitted, but there"
    assert list(got._fields) == [f for f in want._fields if f not in omitted]
    assert got._field_defaults == {k: v for k, v in
                                   want._field_defaults.items()
                                   if k not in omitted}


def test_cli_omissions_are_the_listed_backend_names():
    listed = {f for om in TUPLES.values() for f in om if "backend" in f}
    assert cli.OMITTED_KEYS == listed


def test_named_raises_on_an_unknown_key_by_name():
    from envgs_tpu_torch.models.envgs import EnvGSConfig

    cfg = cli._named(EnvGSConfig, {"specular_threshold": 0.25,
                                   "raster_backend": "pallas"},
                     cli.OMITTED_KEYS)
    assert cfg.specular_threshold == 0.25
    with pytest.raises(KeyError, match="specular_treshold"):
        cli._named(EnvGSConfig, {"specular_treshold": 0.25}, cli.OMITTED_KEYS)
    with pytest.raises(KeyError, match="raster_backend"):
        cli._named(EnvGSConfig, {"raster_backend": "pallas"})


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
