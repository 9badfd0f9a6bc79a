from envgs_tpu_torch.engine.config import Config, load_config, merge_dotted
from envgs_tpu_torch.engine.registry import call_filtered

__all__ = ["Config", "load_config", "merge_dotted", "call_filtered"]
