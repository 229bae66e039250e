"""Gluon surface of the port: parameters, blocks, layers, losses, the
Trainer and the model zoo."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import loss, model_zoo, nn, utils

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "SymbolBlock", "Trainer", "loss",
           "model_zoo", "nn", "utils"]
