from .mesh import TrainState, adam, make_train_step

__all__ = ["TrainState", "adam", "make_train_step"]
