"""Architecture configs of the port (the dense LM archs)."""
from repro_torch.configs.registry import (ARCHS, SHAPES, get_arch,  # noqa: F401
                                          smoke_config)
