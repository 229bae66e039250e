"""Gluon surface of the port: layers and the model zoo."""
from . import model_zoo, nn

__all__ = ["model_zoo", "nn"]
