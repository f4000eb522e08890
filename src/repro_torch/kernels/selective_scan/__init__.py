from .ops import selective_scan, selective_scan_step  # noqa: F401
