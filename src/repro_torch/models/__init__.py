"""Model zoo of the port: the dense and moe LM families (training,
prefill, and KV-cache decode; the moe family with GQA or latent
attention).

Every architecture is selected through ``registry.build_model`` /
``registry.get_config``; ``carry`` loads the JAX package's parameters.
"""

from .registry import ModelApi, build_model, get_config, list_archs

__all__ = ["ModelApi", "build_model", "get_config", "list_archs"]
