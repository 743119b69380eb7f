from .tse import init_model as init_tse_model

__all__ = ["init_tse_model"]
