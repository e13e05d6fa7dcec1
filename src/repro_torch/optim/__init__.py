from repro_torch.optim.adamw import AdamW, AdamWState  # noqa: F401
