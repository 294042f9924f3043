"""Model zoo of the port: the dense LM family (serving: prefill and
KV-cache decode).

Every architecture is selected through ``registry.build_model`` /
``registry.get_config``; ``carry`` loads the JAX package's parameters.
"""

from .registry import ModelApi, build_model, get_config, list_archs

__all__ = ["ModelApi", "build_model", "get_config", "list_archs"]
