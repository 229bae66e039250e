"""Gluon surface of the port: parameters, blocks, layers, recurrent
cells and layers, losses, the Trainer, the model zoo and contrib."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import loss, model_zoo, nn, rnn, utils, contrib

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "SymbolBlock", "Trainer", "loss",
           "model_zoo", "nn", "rnn", "utils", "contrib"]
