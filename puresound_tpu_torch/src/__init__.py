from .filter import Filter, wav_drop_chunk, wav_drop_frequency

__all__ = ["Filter", "wav_drop_chunk", "wav_drop_frequency"]
