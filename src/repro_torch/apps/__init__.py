from .kvstore import DurableKV

__all__ = ["DurableKV"]
