"""Model zoo of the port."""
from . import transformer
from .transformer import TransformerLM, transformer_lm

__all__ = ["transformer", "TransformerLM", "transformer_lm"]
