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

# the JAX package's other registries, declared as it declares them:
# nothing registers into them in either package
DATALOADERS = Registry("dataloaders")
MODELS = Registry("models")
CAMERAS = Registry("cameras")
SUPERVISORS = Registry("supervisors")
RUNNERS = Registry("runners")
OPTIMIZERS = Registry("optimizers")
RECORDERS = Registry("recorders")
EVALUATORS = Registry("evaluators")
VISUALIZERS = Registry("visualizers")

__all__ = ["Config", "load_config", "merge_dotted", "Registry",
           "call_filtered", "DATASETS", "MODERATORS", "TRAINERS",
           "SCHEDULERS", "DATASAMPLERS", "SAMPLERS", "NETWORKS", "EMBEDDERS",
           "REGRESSORS", "RENDERERS", "DATALOADERS", "MODELS", "CAMERAS",
           "SUPERVISORS", "RUNNERS", "OPTIMIZERS", "RECORDERS", "EVALUATORS",
           "VISUALIZERS"]
