from .ops import flash_attention, decode_attention, paged_decode_attention  # noqa: F401
