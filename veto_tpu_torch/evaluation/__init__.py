"""veto_tpu_torch.evaluation."""
