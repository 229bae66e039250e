"""Model zoo of the port: the ResNet vision models and TransformerLM."""
from . import transformer, vision
from .transformer import TransformerLM, transformer_lm
from .vision import get_model

__all__ = ["transformer", "vision", "TransformerLM", "transformer_lm",
           "get_model"]
