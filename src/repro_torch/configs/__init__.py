from repro_torch.configs.registry import (ARCH_IDS, SHAPES, cells, get_config,
                                    smoke_config)  # noqa: F401
