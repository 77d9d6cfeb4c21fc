"""CNN configurations (the paper's networks and the executable mini nets)."""
from repro_torch.configs.cnn import (CNN_CONFIGS, CNNConfig,  # noqa: F401
                                     ConvLayerSpec, get_cnn)
