from envgs_tpu_torch.engine.config import Config, load_config, merge_dotted
from envgs_tpu_torch.engine.registry import Registry, call_filtered

# The registries the port fills (the JAX package's engine/__init__.py has
# the reference's whole taxonomy): datasets, the moderators' schedules and
# the model-family training entry points, the learning-rate schedulers and
# the index samplers, and the model zoo's samplers, networks, embedders,
# regressors and renderers, keyed by the reference's names.
# Components register where they are defined (the model zoo in
# models/__init__.py); importing them fills these.
DATASETS = Registry("datasets")
MODERATORS = Registry("moderators")
TRAINERS = Registry("trainers")
SCHEDULERS = Registry("schedulers")
DATASAMPLERS = Registry("datasamplers")
SAMPLERS = Registry("samplers")
NETWORKS = Registry("networks")
EMBEDDERS = Registry("embedders")
REGRESSORS = Registry("regressors")
RENDERERS = Registry("renderers")

# the JAX package's other registries: nothing of the port registers there
UNPORTED_REGISTRIES = (
    "DATALOADERS", "MODELS", "CAMERAS", "SUPERVISORS", "RUNNERS",
    "OPTIMIZERS", "RECORDERS", "EVALUATORS", "VISUALIZERS")


def __getattr__(name):
    if name in UNPORTED_REGISTRIES:
        raise NotImplementedError(
            f"registry {name}: nothing of the port registers there")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Config", "load_config", "merge_dotted", "Registry",
           "call_filtered", "DATASETS", "MODERATORS", "TRAINERS",
           "SCHEDULERS", "DATASAMPLERS", "SAMPLERS", "NETWORKS", "EMBEDDERS",
           "REGRESSORS", "RENDERERS"]
