from lara_tpu_torch.utils.logging import log, set_verbosity, get_verbosity

__all__ = ["log", "set_verbosity", "get_verbosity"]
