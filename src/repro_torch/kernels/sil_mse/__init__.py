from .ops import sil_mse  # noqa: F401
