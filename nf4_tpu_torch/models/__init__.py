from .llama import init_params

__all__ = ["init_params"]
