"""The paper's own experiment config (§3): 6-layer FC net on EMNIST-47."""
from repro_torch.models.mlp import MLPConfig

CONFIG = MLPConfig()

# paper hyperparameters (§3-§5)
KAPPA = 10.0
N_L = 5
N_R = 160
N_B = 40
N_RECOVERY = 10
BATCH_SIZE = 1410
LR = 0.01
MOMENTUM = 0.9


def smoke():
    return MLPConfig(sizes=(784, 32, 16, 16, 47), cut=2)
