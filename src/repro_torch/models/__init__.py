"""The LM zoo of the port: dense, Mamba-1 and Mamba-2 hybrid families,
full-context forward (``repro_torch.models.zoo.build_model``)."""
