"""Model zoo of the port: the dense and moe LM families (the moe family
with GQA or latent attention), the ssm family (Mamba2) and the hybrid
family (Mamba2 with a shared attention block): training, prefill and
cached decode.

Every architecture is selected through ``registry.build_model`` /
``registry.get_config``; ``carry`` loads the JAX package's parameters.
"""

from .registry import ModelApi, build_model, get_config, list_archs

__all__ = ["ModelApi", "build_model", "get_config", "list_archs"]
