from lara_tpu_torch.io.records import RnaRecord, InputStorage
from lara_tpu_torch.io.writers import OutputLibrary

__all__ = ["RnaRecord", "InputStorage", "OutputLibrary"]
