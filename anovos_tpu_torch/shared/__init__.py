from anovos_tpu_torch.shared.runtime import get_runtime, init_runtime
from anovos_tpu_torch.shared.table import Column, Table

__all__ = ["Column", "Table", "get_runtime", "init_runtime"]
