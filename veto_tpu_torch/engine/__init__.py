"""veto_tpu_torch.engine."""
