from repro_torch.serving.engine import BucketStats, Request, ServingEngine

__all__ = ["BucketStats", "Request", "ServingEngine"]
