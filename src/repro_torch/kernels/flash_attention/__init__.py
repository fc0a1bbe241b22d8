from .ops import flash_attention, flash_attention_auto

__all__ = ["flash_attention", "flash_attention_auto"]
