from qmann_tpu_torch.serve.engine import EngineStats, InferenceEngine, Request
from qmann_tpu_torch.serve.packet import (
    IndexedSample, PacketDecoder, encode_sample, encode_response,
    decode_response, pack, unpack, write_sample_bin,
)

__all__ = [
    "EngineStats", "InferenceEngine", "Request", "IndexedSample",
    "PacketDecoder", "encode_sample", "encode_response", "decode_response",
    "pack", "unpack", "write_sample_bin",
]
