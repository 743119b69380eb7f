from .mesh import (Mesh, TrainState, adam, gathered, make_mesh, make_train_step,
                   replicate_to_mesh, shard_batch, shard_by_slots, shard_state_to_mesh,
                   tp_spec)
from .seqpar import overlapped_chunks, seq_parallel_infer

__all__ = ["Mesh", "make_mesh", "make_train_step", "shard_batch", "TrainState", "adam",
           "gathered", "replicate_to_mesh", "shard_by_slots", "shard_state_to_mesh",
           "tp_spec", "overlapped_chunks", "seq_parallel_infer"]
