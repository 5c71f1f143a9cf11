"""Architecture configs: the ten LM archs of the reference."""
from repro_torch.configs.registry import (ARCHS, SHAPES, get_arch,  # noqa: F401
                                          get_shape, smoke_config)
