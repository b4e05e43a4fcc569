from . import metrics, profiling

__all__ = ["metrics", "profiling"]
