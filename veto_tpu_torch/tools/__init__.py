"""veto_tpu_torch.tools."""
