"""veto_tpu_torch.ops."""
