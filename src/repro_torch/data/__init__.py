from repro_torch.data.pipeline import RequestConfig, poisson_requests

__all__ = ["RequestConfig", "poisson_requests"]
