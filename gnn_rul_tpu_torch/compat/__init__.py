"""Weight interop: JAX-package variables -> the port's state_dict."""

from .jax_import import from_jax_variables

__all__ = ["from_jax_variables"]
