"""veto_tpu_torch.solver."""
