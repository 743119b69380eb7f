"""The H100 limits that the kernels' launch plans are sized against."""
import torch

SMEM_MAX = 232448   # shared memory a block may use on the H100 (bytes)
H100_SMS = 132      # an H100 SXM's SMs: the plans' count where no card is asked


def sm_count(dev) -> int:
    """The card's SMs (the persistent routes' CTAs)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count
