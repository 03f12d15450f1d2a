from qmann_tpu_torch.serve.engine import EngineStats, InferenceEngine, Request

__all__ = ["EngineStats", "InferenceEngine", "Request"]
