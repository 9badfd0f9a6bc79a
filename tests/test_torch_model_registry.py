"""The port's model registries (models/__init__.py) against the JAX
package's: every name JAX's models/__init__.py registers in SAMPLERS,
NETWORKS, EMBEDDERS, REGRESSORS and RENDERERS is registered in the port
and resolves to the port's counterpart (the object of the same name, the
JAX package's own `tests/test_model_registry.py` names among them), and
`build` filters a config's keys by the constructor's signature as JAX's
does."""
import warnings

import pytest

import envgs_tpu.models  # noqa: F401 (JAX's registrations)
import envgs_tpu_torch.models  # noqa: F401 (the port's registrations)
from envgs_tpu import engine as jengine
from envgs_tpu_torch import engine

KINDS = ("SAMPLERS", "NETWORKS", "EMBEDDERS", "REGRESSORS", "RENDERERS")


@pytest.mark.parametrize("kind", KINDS)
def test_every_jax_name_registered(kind):
    jreg, reg = getattr(jengine, kind), getattr(engine, kind)
    assert set(reg._modules) == set(jreg._modules)
    for name in jreg._modules:
        jobj, obj = jreg.get(name), reg.get(name)
        # the counterpart: the port's object of the JAX object's name, from
        # the port's module of the JAX module's name
        assert obj.__name__ == jobj.__name__, name
        assert obj.__module__ == jobj.__module__.replace(
            "envgs_tpu.", "envgs_tpu_torch."), name


def test_reference_names_of_the_jax_test():
    for reg, names in [
        (engine.SAMPLERS, ["EnvGSSampler", "Gaussian2DSampler",
                           "GaussianTSampler", "UniformSampler",
                           "ImportanceSampler"]),
        (engine.NETWORKS, ["VolumetricVideoNetwork", "MultilevelNetwork"]),
        (engine.EMBEDDERS, ["PositionalEncodingEmbedder", "HashEmbedder",
                            "LatentCodeEmbedder", "ComposedXyztEmbedder"]),
        (engine.REGRESSORS, ["MlpRegressor", "SplitRegressor",
                             "SphericalHarmonics", "ContractRegressor"]),
        (engine.RENDERERS, ["VolumeRenderer"]),
    ]:
        for n in names:
            assert n in reg, f"{n} missing from {reg.name}"


def test_build_filters_kwargs_as_jax():
    with pytest.warns(UserWarning, match="not_a_field"):
        cfg = engine.SAMPLERS.build(dict(type="GaussianTSampler",
                                         sh_degree=2, not_a_field=1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jcfg = jengine.SAMPLERS.build(dict(type="GaussianTSampler",
                                           sh_degree=2, not_a_field=1))
    assert cfg.sh_degree == jcfg.sh_degree == 2
    net = engine.NETWORKS.build(dict(type="VolumetricVideoNetwork", width=64))
    assert net.width == 64 and tuple(net) == tuple(jengine.NETWORKS.build(
        dict(type="VolumetricVideoNetwork", width=64)))
    assert engine.SAMPLERS.build(dict(type=None)) is None
    assert engine.SAMPLERS.build(None) is None
    # a module of the zoo: its constructor's keywords, the rest warned of
    with pytest.warns(UserWarning, match="bogus"):
        emb = engine.EMBEDDERS.build(dict(type="HashEmbedder", n_levels=3,
                                          log2_hashmap_size=8, bogus=1))
    assert emb.out_dim == 3 * 2 and tuple(emb.tables.shape) == (3, 256, 2)
    with pytest.raises(KeyError, match="NoSuchNetwork"):
        engine.NETWORKS.get("NoSuchNetwork")
