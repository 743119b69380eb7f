"""The TSE recipe (`python -m puresound_tpu_torch.egs.tse.main`)."""
