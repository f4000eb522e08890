"""Data pipelines (numpy, bit-identical to ``repro.data``'s)."""
from .images import emnist_like, load_emnist  # noqa: F401
from .lm import lm_batch_at, lm_batches, synthetic_token_stream  # noqa: F401
from .loader import Batches  # noqa: F401
