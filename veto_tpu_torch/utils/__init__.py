"""veto_tpu_torch.utils."""
