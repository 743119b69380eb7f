"""The DSS recipe (`python -m puresound_tpu_torch.egs.dss.main`)."""
