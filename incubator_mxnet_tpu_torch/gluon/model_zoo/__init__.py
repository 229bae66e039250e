"""Model zoo of the port: the vision models, the local pretrained-weight
store and TransformerLM."""
from . import model_store, transformer, vision
from .transformer import TransformerLM, transformer_lm
from .vision import get_model

__all__ = ["model_store", "transformer", "vision", "TransformerLM",
           "transformer_lm", "get_model"]
