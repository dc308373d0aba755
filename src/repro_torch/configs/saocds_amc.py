"""The paper's own model: 5-layer SNN AMC classifier (Fig. 7 / Table II)."""
from repro_torch.models.snn import SNNConfig

CONFIG = SNNConfig()  # paper defaults: (11,2,16)(11,16,32)(5,32,64) + FCs

# Table V layer-wise density configurations
DENSITY_CONFIGS = {
    "saocds-100": 1.00,
    "saocds-75": 0.75,
    "saocds-50": 0.50,
    "saocds-25": 0.25,
    "saocds-20": 0.20,
    "saocds-15": 0.15,
    "saocds-10": 0.10,
    "saocds-5": 0.05,
    "saocds-25-20-15-20-25": {
        "conv1": 0.25, "conv2": 0.20, "conv3": 0.15, "fc1": 0.20, "fc2": 0.25
    },
    "saocds-20-15-10-15-20": {
        "conv1": 0.20, "conv2": 0.15, "conv3": 0.10, "fc1": 0.15, "fc2": 0.20
    },
}
