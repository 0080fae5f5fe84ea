from repro_torch.serve.engine import Request, ServingEngine  # noqa: F401
