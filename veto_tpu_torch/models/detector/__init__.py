"""veto_tpu_torch.models.detector."""
