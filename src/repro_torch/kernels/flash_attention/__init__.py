from .kernel import flash_attention
from .ops import attention, attention_plain
from .ref import attention_ref

__all__ = ["attention", "attention_plain", "attention_ref", "flash_attention"]
