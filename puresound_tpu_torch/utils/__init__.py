from .model_info import count_params, probe_lookahead_receptive

__all__ = ["count_params", "probe_lookahead_receptive"]
