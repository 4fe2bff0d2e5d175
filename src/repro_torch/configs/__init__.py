"""Architecture configs (one module per assigned arch): numbers only."""
from repro_torch.configs.registry import (ALIASES, ARCHS, SHAPES, LONG_OK,
                                          ShapeSpec, all_cells, get_config,
                                          shape_specs)
