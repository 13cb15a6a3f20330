"""veto_tpu_torch.data."""
