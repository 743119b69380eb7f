from .ns import init_model as init_ns_model
from .tse import init_model as init_tse_model

__all__ = ["init_ns_model", "init_tse_model"]
