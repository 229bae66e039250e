"""Backend-free helpers of the port (twins of the JAX package's
``utils`` modules that the port needs)."""
from .env import EnvFlag, get_env, register_env, list_env
from .registry import Registry, get_registry
from .log import get_logger

__all__ = [
    "EnvFlag", "get_env", "register_env", "list_env",
    "Registry", "get_registry", "get_logger",
]
