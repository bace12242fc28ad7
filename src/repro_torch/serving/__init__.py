"""Serving of the LM zoo: the sampler and the continuous-batching engine
(counterpart of ``repro.serving``)."""
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.engine import Request, ServingEngine

__all__ = ["Request", "SamplerConfig", "ServingEngine", "sample"]
