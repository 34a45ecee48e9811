from repro_torch.data.pipeline import DataConfig, RequestConfig, poisson_requests, token_stream

__all__ = ["DataConfig", "RequestConfig", "poisson_requests", "token_stream"]
