"""The NS recipe (`python -m puresound_tpu_torch.egs.ns.main`)."""
