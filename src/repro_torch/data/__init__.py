from repro_torch.data.synthetic import TokenStream  # noqa: F401
